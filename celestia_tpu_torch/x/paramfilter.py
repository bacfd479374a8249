"""x/paramfilter — blocks hard-fork-only parameters from governance.

Reference semantics: x/paramfilter/gov_handler.go:16-40 (a wrapper around
the params gov handler that rejects proposals touching blocked params) and
the blocked list wired at app/app.go:734-745.
"""

from __future__ import annotations

import dataclasses

# ref: app/app.go:734-745
FORBIDDEN_PARAMS: frozenset[tuple[str, str]] = frozenset(
    {
        ("bank", "SendEnabled"),
        ("staking", "UnbondingTime"),
        ("staking", "BondDenom"),
        ("consensus", "validator_pub_key_types"),
    }
)


@dataclasses.dataclass
class ParamChange:
    subspace: str
    key: str
    value: str


class ForbiddenParamError(Exception):
    pass


class ParamFilter:
    def __init__(self, forbidden=FORBIDDEN_PARAMS):
        self.forbidden = forbidden

    def check(self, changes: list[ParamChange]) -> None:
        """ref: gov_handler.go:29 — reject the whole proposal if any change
        touches a blocked parameter."""
        for change in changes:
            if (change.subspace, change.key) in self.forbidden:
                raise ForbiddenParamError(
                    f"parameter {change.subspace}/{change.key} can only be "
                    "changed through a hardfork"
                )


def apply_param_changes(app, changes: list[ParamChange]) -> None:
    """Gov-approved parameter application (the params keeper role), guarded
    by the filter."""
    ParamFilter().check(changes)
    for change in changes:
        if change.subspace == "blob":
            params = app.blob.get_params()
            if change.key == "GasPerBlobByte":
                params.gas_per_blob_byte = int(change.value)
            elif change.key == "GovMaxSquareSize":
                params.gov_max_square_size = int(change.value)
            else:
                raise ValueError(f"unknown blob param {change.key}")
            app.blob.set_params(params)
        elif change.subspace == "blobstream":
            if change.key == "DataCommitmentWindow":
                app.blobstream.data_commitment_window = int(change.value)
            else:
                raise ValueError(f"unknown blobstream param {change.key}")
        elif change.subspace == "ibc":
            # gov-driven frozen-client recovery (the reference routes
            # ibc-go's ClientUpdateProposal through a dedicated gov
            # handler, app/ibc_proposal_handler.go:17-28). Same guard
            # surface as every other gov change: the filter above ran,
            # and the recovery itself enforces the 02-client
            # substitution rules (frozen/expired subject, active
            # substitute, same chain, height advance).
            if change.key == "RecoverClient":
                import json as _json

                from celestia_tpu_torch.x.lightclient import ClientKeeper

                v = _json.loads(change.value)
                ClientKeeper(app.store).recover_client(
                    v["subject_client_id"], v["substitute_client_id"]
                )
            else:
                raise ValueError(f"unknown ibc param {change.key}")
        else:
            raise ValueError(f"unknown subspace {change.subspace}")
