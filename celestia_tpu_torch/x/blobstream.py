"""x/blobstream (QGB) — Ethereum bridge attestations.

Reference semantics: x/blobstream/abci.go (EndBlocker: valset update on
>5% bonded-power change or recent unbonding, data commitments over
DataCommitmentWindow block ranges, pruning after AttestationExpiryTime),
keeper_attestation.go / keeper_data_commitment.go (monotonic nonces),
keeper/msg_server.go (validator EVM address registration), hooks into
staking (registered app/app.go:349-354).
"""

from __future__ import annotations

import dataclasses
import json

ATTESTATION_PREFIX = b"blobstream/attestation/"
LATEST_NONCE_KEY = b"blobstream/latestNonce"
EARLIEST_NONCE_KEY = b"blobstream/earliestNonce"
EVM_ADDRESS_PREFIX = b"blobstream/evmAddress/"

DEFAULT_DATA_COMMITMENT_WINDOW = 400  # ref: x/blobstream/types/params.go
ATTESTATION_EXPIRY_SECONDS = 3 * 7 * 24 * 3600  # 3 weeks
SIGNIFICANT_POWER_DIFF = 0.05  # ref: x/blobstream/abci.go:26


@dataclasses.dataclass
class BridgeValidator:
    power: int  # normalized to uint32 max total (Gravity convention)
    evm_address: str


@dataclasses.dataclass
class Valset:
    nonce: int
    members: list[BridgeValidator]
    height: int
    time: float

    type: str = "valset"

    def to_json(self) -> dict:
        return {
            "type": self.type,
            "nonce": self.nonce,
            "height": self.height,
            "time": self.time,
            "members": [dataclasses.asdict(m) for m in self.members],
        }


@dataclasses.dataclass
class DataCommitment:
    nonce: int
    begin_block: int
    end_block: int
    time: float

    type: str = "data_commitment"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


NORMALIZED_POWER = 2**32 - 1

URL_MSG_REGISTER_EVM_ADDRESS = "/celestia.qgb.v1.MsgRegisterEVMAddress"


def _register_msg_types():
    from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
    from celestia_tpu_torch.tx import register_msg

    @register_msg(URL_MSG_REGISTER_EVM_ADDRESS)
    @dataclasses.dataclass
    class MsgRegisterEVMAddress:
        validator_address: str
        evm_address: str

        def get_signers(self) -> list[str]:
            """ref: x/blobstream MsgRegisterEVMAddress.GetSigners — only the
            validator operator may register its own EVM address."""
            return [self.validator_address]

        def marshal(self) -> bytes:
            return _field_bytes(1, self.validator_address.encode()) + _field_bytes(
                2, self.evm_address.encode()
            )

        @classmethod
        def unmarshal(cls, raw: bytes) -> "MsgRegisterEVMAddress":
            m = cls("", "")
            for tag, wt, val in _parse_fields(raw):
                if tag == 1:
                    _require_wt(wt, 2, tag)
                    m.validator_address = bytes(val).decode()
                elif tag == 2:
                    _require_wt(wt, 2, tag)
                    m.evm_address = bytes(val).decode()
            return m

        def validate_basic(self) -> None:
            if not (self.evm_address.startswith("0x") and len(self.evm_address) == 42):
                raise ValueError("invalid EVM address")

    return MsgRegisterEVMAddress


MsgRegisterEVMAddress = _register_msg_types()


WINDOW_PARAM_KEY = b"blobstream/dataCommitmentWindow"


class BlobstreamKeeper:
    def __init__(self, store, staking):
        self.store = store
        self.staking = staking

    @property
    def data_commitment_window(self) -> int:
        raw = self.store.get(WINDOW_PARAM_KEY)
        return int.from_bytes(raw, "big") if raw else DEFAULT_DATA_COMMITMENT_WINDOW

    @data_commitment_window.setter
    def data_commitment_window(self, window: int) -> None:
        self.store.set(WINDOW_PARAM_KEY, int(window).to_bytes(8, "big"))

    # staking hook (ref: x/blobstream/keeper/hooks.go)
    def after_validator_bond_change(self, ctx) -> None:
        pass  # unbonding height is read from staking at EndBlock

    # --- attestation store ---

    def latest_nonce(self) -> int:
        raw = self.store.get(LATEST_NONCE_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def _set_attestation(self, att) -> None:
        nonce = self.latest_nonce() + 1
        att.nonce = nonce
        self.store.set(
            ATTESTATION_PREFIX + nonce.to_bytes(8, "big"),
            json.dumps(att.to_json(), sort_keys=True).encode(),
        )
        self.store.set(LATEST_NONCE_KEY, nonce.to_bytes(8, "big"))
        if self.store.get(EARLIEST_NONCE_KEY) is None:
            self.store.set(EARLIEST_NONCE_KEY, nonce.to_bytes(8, "big"))

    def get_attestation(self, nonce: int) -> dict | None:
        raw = self.store.get(ATTESTATION_PREFIX + nonce.to_bytes(8, "big"))
        return json.loads(raw) if raw else None

    def latest_valset(self) -> dict | None:
        for nonce in range(self.latest_nonce(), 0, -1):
            att = self.get_attestation(nonce)
            if att is not None and att.get("type") == "valset":
                return att
        return None

    def latest_data_commitment(self) -> dict | None:
        for nonce in range(self.latest_nonce(), 0, -1):
            att = self.get_attestation(nonce)
            if att is not None and att.get("type") == "data_commitment":
                return att
        return None

    # --- EVM address registration (ref: keeper/msg_server.go) ---

    def register_evm_address(self, validator: str, evm_address: str) -> None:
        if self.staking.get_validator(validator) is None:
            raise ValueError(f"validator {validator} does not exist")
        if not (evm_address.startswith("0x") and len(evm_address) == 42):
            raise ValueError("invalid EVM address")
        self.store.set(EVM_ADDRESS_PREFIX + validator.encode(), evm_address.encode())

    def evm_address(self, validator: str) -> str | None:
        raw = self.store.get(EVM_ADDRESS_PREFIX + validator.encode())
        return raw.decode() if raw else None

    # --- current bridge valset (ref: keeper/keeper_valset.go GetCurrentValset) ---

    def current_valset_members(self) -> list[BridgeValidator]:
        from celestia_tpu_torch.x.blobstream_abi import eip55_checksum_address

        validators = self.staking.bonded_validators()
        total = sum(v.power for v in validators)
        if total == 0:
            return []
        members = []
        for v in validators:
            evm = self.evm_address(v.operator) or "0x" + "00" * 20
            members.append(
                BridgeValidator(power=v.power * NORMALIZED_POWER // total,
                                evm_address=evm)
            )
        # ref: x/blobstream/types/validator.go:86-99 Sort — descending
        # bridge power, ties broken on the EIP-55 checksummed hex string
        members.sort(key=lambda m: (-m.power, eip55_checksum_address(m.evm_address)))
        return members

    # --- query server (ref: x/blobstream/keeper/query.go) ---

    def earliest_nonce(self) -> int:
        raw = self.store.get(EARLIEST_NONCE_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def data_commitment_range_for_height(self, height: int) -> dict | None:
        """The data commitment attestation whose [begin, end] range covers
        height (ref: QueryDataCommitmentRangeForHeight, used by
        client/verify.go:244)."""
        for nonce in range(self.latest_nonce(), 0, -1):
            att = self.get_attestation(nonce)
            if (
                att is not None
                and att.get("type") == "data_commitment"
                and att["begin_block"] <= height <= att["end_block"]
            ):
                return att
        return None

    def valset_request_before_nonce(self, nonce: int) -> dict | None:
        """The last valset strictly before the given attestation nonce — the
        set the contract holds when processing that attestation
        (ref: QueryLatestValsetRequestBeforeNonce)."""
        for n in range(min(nonce - 1, self.latest_nonce()), 0, -1):
            att = self.get_attestation(n)
            if att is not None and att.get("type") == "valset":
                return att
        return None

    # --- EndBlocker (ref: x/blobstream/abci.go:28-130) ---

    def end_blocker(self, ctx) -> None:
        self._handle_valset_request(ctx)
        self._handle_data_commitment_request(ctx)
        self._prune_attestations(ctx)

    def _handle_valset_request(self, ctx) -> None:
        latest = self.latest_valset()
        members = self.current_valset_members()
        if not members:
            return
        if latest is None:
            self._set_attestation(
                Valset(0, members, ctx.block_height, ctx.block_time)
            )
            return
        unbonding_height = self.staking.last_unbonding_height()
        power_diff = self._power_diff(latest["members"], members)
        if unbonding_height == ctx.block_height or power_diff > SIGNIFICANT_POWER_DIFF:
            self._set_attestation(
                Valset(0, members, ctx.block_height, ctx.block_time)
            )

    @staticmethod
    def _power_diff(old_members: list[dict], new_members: list[BridgeValidator]) -> float:
        """Sum of absolute power changes relative to total normalized power
        (gravity PowerDiff)."""
        old = {m["evm_address"]: m["power"] for m in old_members}
        new = {m.evm_address: m.power for m in new_members}
        delta = 0
        for addr in set(old) | set(new):
            delta += abs(new.get(addr, 0) - old.get(addr, 0))
        return delta / NORMALIZED_POWER

    def _handle_data_commitment_request(self, ctx) -> None:
        window = self.data_commitment_window
        while True:
            latest = self.latest_data_commitment()
            if latest is not None:
                if ctx.block_height - latest["end_block"] >= window:
                    begin = latest["end_block"] + 1
                    self._set_attestation(
                        DataCommitment(0, begin, begin + window - 1, ctx.block_time)
                    )
                else:
                    break
            else:
                if ctx.block_height >= window:
                    self._set_attestation(
                        DataCommitment(0, 1, window, ctx.block_time)
                    )
                else:
                    break

    def _prune_attestations(self, ctx) -> None:
        raw = self.store.get(EARLIEST_NONCE_KEY)
        if raw is None:
            return
        earliest = int.from_bytes(raw, "big")
        latest = self.latest_nonce()
        while earliest <= latest:
            att = self.get_attestation(earliest)
            if att is None or ctx.block_time - att["time"] < ATTESTATION_EXPIRY_SECONDS:
                break
            self.store.delete(ATTESTATION_PREFIX + earliest.to_bytes(8, "big"))
            earliest += 1
        self.store.set(EARLIEST_NONCE_KEY, earliest.to_bytes(8, "big"))
