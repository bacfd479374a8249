"""x/vesting — vesting accounts (cosmos-sdk auth/vesting module).

Reference wiring: app/app.go:154 (vesting.AppModuleBasic), app/app.go:429.
Supports the two schedule shapes celestia uses:

- ContinuousVestingAccount: coins unlock linearly between start and end
- DelayedVestingAccount: everything unlocks at end_time
- PeriodicVestingAccount: coins unlock in discrete tranches — a list of
  (length_seconds, amount) periods starting at start_time; a tranche
  vests when its cumulative end time passes

Locked (still-vesting) coins cannot be TRANSFERRED; they can be delegated
(sdk semantics — staking locked coins is explicitly allowed). Enforcement
lives at the bank-send boundary: the message router consults
`locked_coins(addr, now)` before moving funds out of a vesting account.
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
from celestia_tpu_torch.tx import register_msg

VESTING_PREFIX = b"vesting/account/"


@dataclasses.dataclass
class VestingSchedule:
    address: str
    original_vesting: int  # utia
    start_time: float
    end_time: float
    delayed: bool = False  # True = DelayedVesting, False = Continuous
    # PeriodicVestingAccount: [(length_seconds, amount), …] from
    # start_time; when set it overrides the continuous/delayed shapes
    # (sum of amounts == original_vesting, validated at creation)
    periods: list | None = None

    def locked(self, now: float) -> int:
        """Still-vesting (untransferable) amount at time `now`.
        ref: vesting types LockedCoins (continuous/delayed/periodic)."""
        if self.periods is not None:
            t = self.start_time
            vested = 0
            for length, amount in self.periods:
                t += float(length)
                if now < t:
                    break
                vested += int(amount)
            return self.original_vesting - vested
        if now >= self.end_time:
            return 0
        if self.delayed:
            return self.original_vesting
        if now <= self.start_time:
            return self.original_vesting
        elapsed = now - self.start_time
        duration = self.end_time - self.start_time
        vested = int(self.original_vesting * elapsed / duration)
        return self.original_vesting - vested

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "VestingSchedule":
        d = json.loads(raw)
        if d.get("periods") is not None:
            d["periods"] = [(float(ln), int(amt)) for ln, amt in d["periods"]]
        return cls(**d)


class VestingKeeper:
    def __init__(self, store, bank):
        self.store = store
        self.bank = bank

    def get_schedule(self, address: str) -> VestingSchedule | None:
        raw = self.store.get(VESTING_PREFIX + address.encode())
        return VestingSchedule.unmarshal(raw) if raw else None

    def locked_coins(self, address: str, now: float) -> int:
        schedule = self.get_schedule(address)
        return schedule.locked(now) if schedule else 0

    def spendable_balance(self, address: str, now: float) -> int:
        return max(self.bank.get_balance(address) - self.locked_coins(address, now), 0)

    def assert_spendable(self, address: str, amount: int, now: float) -> None:
        """The bank-send gate: transfers out of a vesting account may only
        touch the vested portion (sdk bank SpendableCoins check)."""
        spendable = self.spendable_balance(address, now)
        if amount > spendable:
            locked = self.locked_coins(address, now)
            raise ValueError(
                f"insufficient spendable balance: {amount} requested, "
                f"{spendable} spendable ({locked} still vesting)"
            )

    def create_vesting_account(
        self, ctx, funder: str, to_address: str, amount: int,
        end_time: float, delayed: bool,
    ) -> None:
        """ref: vesting msg_server CreateVestingAccount: the target must
        be a fresh account; funds move from the funder and the whole
        amount starts locked."""
        from celestia_tpu_torch.x.auth import AccountKeeper

        if amount <= 0:
            raise ValueError("vesting amount must be positive")
        if end_time <= ctx.block_time:
            raise ValueError("vesting end time is in the past")
        accounts = AccountKeeper(self.store)
        if accounts.get_account(to_address) is not None:
            raise ValueError(f"account {to_address} already exists")
        if self.get_schedule(to_address) is not None:
            raise ValueError(f"account {to_address} already has a schedule")
        self.bank.send(funder, to_address, amount)
        accounts.get_or_create(to_address)
        self.store.set(
            VESTING_PREFIX + to_address.encode(),
            VestingSchedule(
                address=to_address,
                original_vesting=amount,
                start_time=ctx.block_time,
                end_time=end_time,
                delayed=delayed,
            ).marshal(),
        )


    def create_periodic_vesting_account(
        self, ctx, funder: str, to_address: str, periods: list,
    ) -> None:
        """ref: vesting msg_server CreatePeriodicVestingAccount: fresh
        target account; total = sum of tranche amounts, all locked at
        creation; tranche i vests at start + Σ lengths[0..i]."""
        from celestia_tpu_torch.x.auth import AccountKeeper

        if not periods:
            raise ValueError("periodic vesting needs at least one period")
        total = 0
        for length, amount in periods:
            if float(length) <= 0:
                raise ValueError("vesting period length must be positive")
            if int(amount) <= 0:
                raise ValueError("vesting period amount must be positive")
            total += int(amount)
        accounts = AccountKeeper(self.store)
        if accounts.get_account(to_address) is not None:
            raise ValueError(f"account {to_address} already exists")
        if self.get_schedule(to_address) is not None:
            raise ValueError(f"account {to_address} already has a schedule")
        self.bank.send(funder, to_address, total)
        accounts.get_or_create(to_address)
        start = ctx.block_time
        self.store.set(
            VESTING_PREFIX + to_address.encode(),
            VestingSchedule(
                address=to_address,
                original_vesting=total,
                start_time=start,
                end_time=start + sum(float(ln) for ln, _a in periods),
                periods=[(float(ln), int(amt)) for ln, amt in periods],
            ).marshal(),
        )


URL_MSG_CREATE_VESTING_ACCOUNT = "/cosmos.vesting.v1beta1.MsgCreateVestingAccount"
URL_MSG_CREATE_PERIODIC_VESTING_ACCOUNT = (
    "/cosmos.vesting.v1beta1.MsgCreatePeriodicVestingAccount"
)


@register_msg(URL_MSG_CREATE_VESTING_ACCOUNT)
@dataclasses.dataclass
class MsgCreateVestingAccount:
    from_address: str
    to_address: str
    amount: int
    end_time: float
    delayed: bool = False

    def get_signers(self) -> list[str]:
        return [self.from_address]

    def marshal(self) -> bytes:
        out = (
            _field_bytes(1, self.from_address.encode())
            + _field_bytes(2, self.to_address.encode())
            + _field_bytes(3, str(self.amount).encode())
            + _field_bytes(4, str(self.end_time).encode())
        )
        if self.delayed:
            out += _field_bytes(5, b"1")
        return out

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCreateVestingAccount":
        m = cls("", "", 0, 0.0)
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.from_address = bytes(val).decode()
            elif tag == 2:
                m.to_address = bytes(val).decode()
            elif tag == 3:
                m.amount = int(bytes(val).decode())
            elif tag == 4:
                m.end_time = float(bytes(val).decode())
            elif tag == 5:
                m.delayed = bytes(val) == b"1"
        return m

    def validate_basic(self) -> None:
        if not self.from_address or not self.to_address:
            raise ValueError("from and to addresses required")
        if self.amount <= 0:
            raise ValueError("vesting amount must be positive")


@register_msg(URL_MSG_CREATE_PERIODIC_VESTING_ACCOUNT)
@dataclasses.dataclass
class MsgCreatePeriodicVestingAccount:
    """ref: cosmos.vesting.v1beta1.MsgCreatePeriodicVestingAccount
    (wired through app/app.go:154's vesting module)."""

    from_address: str
    to_address: str
    periods: list  # [(length_seconds, amount), …]

    def get_signers(self) -> list[str]:
        return [self.from_address]

    def marshal(self) -> bytes:
        return (
            _field_bytes(1, self.from_address.encode())
            + _field_bytes(2, self.to_address.encode())
            + _field_bytes(
                3,
                json.dumps(
                    [[float(ln), int(amt)] for ln, amt in self.periods],
                    sort_keys=True,
                    separators=(",", ":"),
                ).encode(),
            )
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MsgCreatePeriodicVestingAccount":
        m = cls("", "", [])
        for tag, wt, val in _parse_fields(raw):
            _require_wt(wt, 2, tag)
            if tag == 1:
                m.from_address = bytes(val).decode()
            elif tag == 2:
                m.to_address = bytes(val).decode()
            elif tag == 3:
                m.periods = [
                    (float(ln), int(amt)) for ln, amt in json.loads(bytes(val))
                ]
        return m

    def validate_basic(self) -> None:
        if not self.from_address or not self.to_address:
            raise ValueError("from and to addresses required")
        if not self.periods:
            raise ValueError("at least one vesting period required")
        for length, amount in self.periods:
            if float(length) <= 0 or int(amount) <= 0:
                raise ValueError("vesting periods must have positive length and amount")
