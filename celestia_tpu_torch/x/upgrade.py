"""x/upgrade — signal-free coordinated upgrades (ADR-018).

Reference semantics: x/upgrade/upgrade.go (node-local Schedule per
chain-ID; proposer injects MsgVersionChange as the first tx when inside
the window), x/upgrade/types.go (schedule validation, IsUpgradeMsg),
app/deliver_tx.go (DeliverTx arms the pending version),
app/app.go:575-587 (EndBlocker bumps the app version).
"""

from __future__ import annotations

import dataclasses

from celestia_tpu_torch.blob import _field_uint, _parse_fields, _require_wt
from celestia_tpu_torch.tx import Tx, register_msg

URL_MSG_VERSION_CHANGE = "/celestia.upgrade.MsgVersionChange"


@register_msg(URL_MSG_VERSION_CHANGE)
@dataclasses.dataclass
class MsgVersionChange:
    version: int

    def marshal(self) -> bytes:
        return _field_uint(1, self.version)

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgVersionChange":
        m = cls(0)
        for tag, wt, val in _parse_fields(raw):
            if tag == 1:
                _require_wt(wt, 0, tag)
                m.version = int(val)
        return m

    def validate_basic(self) -> None:
        pass  # ref: x/upgrade/types.go ValidateBasic returns nil

    def get_signers(self) -> list[str]:
        return []  # proposer-injected; carries no signers (x/upgrade/types.go)

    @staticmethod
    def from_msgs(msgs: list):
        """ref: x/upgrade/types.go IsUpgradeMsg (single-msg txs only)."""
        if len(msgs) == 1 and isinstance(msgs[0], MsgVersionChange):
            return msgs[0].version
        return None

    @classmethod
    def as_tx_bytes(cls, version: int) -> bytes:
        """Unsigned single-msg tx carrying the version change
        (ref: x/upgrade/types.go NewMsgVersionChange; the msg has no
        signers)."""
        from celestia_tpu_torch.tx import Fee

        tx = Tx(msgs=[cls(version)], signer_infos=[], fee=Fee(), signatures=[])
        return tx.marshal()


@dataclasses.dataclass
class Plan:
    start: int
    end: int
    version: int

    def validate_basic(self) -> None:
        if self.start <= 0:
            raise ValueError("plan start must be positive")
        if self.end < self.start:
            raise ValueError("plan end must be >= start")
        if self.version == 0:
            raise ValueError("plan version must be non-zero")


class Schedule:
    """Ordered upgrade plans. ref: x/upgrade/types.go Schedule"""

    def __init__(self, plans: list[Plan]):
        self.plans = plans

    def validate_basic(self) -> None:
        last_height = 0
        last_version = 0
        for idx, plan in enumerate(self.plans):
            plan.validate_basic()
            if plan.start <= last_height:
                raise ValueError(f"plan {idx}: start must be greater than {last_height}")
            if plan.version <= last_version:
                raise ValueError(f"plan {idx}: version must be greater than {last_version}")
            last_height = plan.end
            last_version = plan.version

    def should_propose_upgrade(self, height: int):
        for plan in self.plans:
            if plan.start <= height <= plan.end:
                return plan.version
        return None


class UpgradeKeeper:
    """ref: x/upgrade/upgrade.go Keeper"""

    def __init__(self, schedule_by_chain: dict[str, Schedule]):
        for schedule in schedule_by_chain.values():
            schedule.validate_basic()
        self.schedule_by_chain = schedule_by_chain
        self.pending_app_version = 0

    def should_propose_upgrade(self, chain_id: str, height: int):
        schedule = self.schedule_by_chain.get(chain_id)
        if schedule is None:
            return None
        return schedule.should_propose_upgrade(height)

    def prepare_upgrade_at_end_block(self, version: int) -> None:
        self.pending_app_version = version

    def should_upgrade(self) -> bool:
        return self.pending_app_version != 0

    def mark_upgrade_complete(self) -> None:
        self.pending_app_version = 0
