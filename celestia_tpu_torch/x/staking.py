"""x/staking analogue: bonded validator set with voting power.

The reference wires the stock SDK staking module (app/app.go:209-239,
BondDenom=utia). The capabilities the DA chain itself exercises are the
bonded validator set (consensus power, blobstream valsets hook into it)
and delegate/undelegate flows; this module provides those over the
framework's store + msg registry.
"""

from __future__ import annotations

import dataclasses
import json

from celestia_tpu_torch.blob import _field_bytes, _parse_fields, _require_wt
from celestia_tpu_torch.tx import register_msg
from celestia_tpu_torch.x.bank import BONDED_POOL, NOT_BONDED_POOL

VALIDATOR_PREFIX = b"staking/validator/"
DELEGATION_PREFIX = b"staking/delegation/"
UNBONDING_PREFIX = b"staking/unbonding/"
# schedule index: [ [completion_time, delegator, validator], ... ] — the
# sdk UnbondingQueue analogue, so the per-block EndBlocker never scans
# the whole state for matured entries
UNBONDING_QUEUE_KEY = b"staking/unbondingQueue"
LAST_UNBONDING_HEIGHT_KEY = b"staking/lastUnbondingHeight"
UNBONDING_TIME_KEY = b"staking/params/unbondingTime"
POWER_REDUCTION = 1_000_000  # utia per unit of consensus power


def _delegation_key(delegator: str, validator: str) -> bytes:
    return DELEGATION_PREFIX + delegator.encode() + b"/" + validator.encode()


def _unbonding_key(delegator: str, validator: str) -> bytes:
    return UNBONDING_PREFIX + delegator.encode() + b"/" + validator.encode()


@dataclasses.dataclass
class UnbondingEntry:
    """One undelegation awaiting maturity (sdk UnbondingDelegationEntry)."""

    creation_height: int
    completion_time: float
    balance: int


@dataclasses.dataclass
class Validator:
    operator: str  # bech32 account address of the operator
    tokens: int  # bonded utia
    moniker: str = ""
    jailed: bool = False
    # consensus pubkey (hex compressed secp256k1) — what signs block
    # headers; consumed by light clients tracking this chain (the SDK
    # Validator.ConsensusPubkey analogue). Empty for validators that
    # never sign (pure staking tests).
    pubkey: str = ""

    @property
    def power(self) -> int:
        return 0 if self.jailed else self.tokens // POWER_REDUCTION

    def marshal(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Validator":
        return cls(**json.loads(raw))


class StakingKeeper:
    def __init__(self, store, bank):
        self.store = store
        self.bank = bank
        self.hooks: list = []  # e.g. blobstream (app/app.go:349-354)

    def get_validator(self, operator: str) -> Validator | None:
        raw = self.store.get(VALIDATOR_PREFIX + operator.encode())
        return Validator.unmarshal(raw) if raw else None

    def set_validator(self, v: Validator) -> None:
        self.store.set(VALIDATOR_PREFIX + v.operator.encode(), v.marshal())

    def bonded_validators(self) -> list[Validator]:
        vals = [
            Validator.unmarshal(raw)
            for _k, raw in self.store.iter_prefix(VALIDATOR_PREFIX)
        ]
        vals = [v for v in vals if v.power > 0]
        # deterministic order: descending power, then operator
        vals.sort(key=lambda v: (-v.power, v.operator))
        return vals

    def total_power(self) -> int:
        return sum(v.power for v in self.bonded_validators())

    def get_delegation(self, delegator: str, validator_operator: str) -> int:
        raw = self.store.get(_delegation_key(delegator, validator_operator))
        return int.from_bytes(raw, "big") if raw else 0

    def _set_delegation(self, delegator: str, validator_operator: str, tokens: int) -> None:
        key = _delegation_key(delegator, validator_operator)
        if tokens > 0:
            self.store.set(key, tokens.to_bytes(16, "big"))
        else:
            self.store.delete(key)

    def delegate(self, ctx, delegator: str, validator_operator: str, amount: int) -> None:
        self.bank.send(delegator, BONDED_POOL, amount)
        v = self.get_validator(validator_operator) or Validator(validator_operator, 0)
        v.tokens += amount
        self.set_validator(v)
        self._set_delegation(
            delegator, validator_operator,
            self.get_delegation(delegator, validator_operator) + amount,
        )

    # --- unbonding (sdk Undelegate -> UnbondingDelegation -> completion) ---

    @property
    def unbonding_time(self) -> float:
        """Seconds until an undelegation matures (ref: appconsts
        DefaultUnbondingTime = 3 weeks; governance-settable)."""
        raw = self.store.get(UNBONDING_TIME_KEY)
        if raw is None:
            from celestia_tpu_torch.appconsts import DEFAULT_UNBONDING_TIME_SECONDS

            return float(DEFAULT_UNBONDING_TIME_SECONDS)
        return float(json.loads(raw))

    @unbonding_time.setter
    def unbonding_time(self, seconds: float) -> None:
        self.store.set(UNBONDING_TIME_KEY, json.dumps(float(seconds)).encode())

    def unbonding_entries(self, delegator: str, validator: str) -> list[UnbondingEntry]:
        raw = self.store.get(_unbonding_key(delegator, validator))
        if not raw:
            return []
        return [UnbondingEntry(**e) for e in json.loads(raw)]

    def _set_unbonding_entries(
        self, delegator: str, validator: str, entries: list[UnbondingEntry]
    ) -> None:
        key = _unbonding_key(delegator, validator)
        if entries:
            self.store.set(
                key,
                json.dumps([dataclasses.asdict(e) for e in entries],
                           sort_keys=True).encode(),
            )
        else:
            self.store.delete(key)

    def _unbonding_queue(self) -> list[list]:
        raw = self.store.get(UNBONDING_QUEUE_KEY)
        return json.loads(raw) if raw else []

    def _set_unbonding_queue(self, queue: list[list]) -> None:
        if queue:
            self.store.set(
                UNBONDING_QUEUE_KEY, json.dumps(queue, sort_keys=True).encode()
            )
        else:
            self.store.delete(UNBONDING_QUEUE_KEY)

    def _iter_unbondings(self):
        """Yield (delegator, validator, entries) for every pair with
        outstanding unbonding entries, via the queue index (no full-state
        prefix scan)."""
        seen = set()
        for _time, delegator, validator in self._unbonding_queue():
            if (delegator, validator) in seen:
                continue
            seen.add((delegator, validator))
            entries = self.unbonding_entries(delegator, validator)
            if entries:
                yield delegator, validator, entries

    def undelegate(self, ctx, delegator: str, validator_operator: str, amount: int) -> None:
        """Voting power drops immediately; tokens move to the not-bonded
        pool and pay out only after the unbonding period (sdk
        Keeper.Undelegate + UnbondingDelegation semantics)."""
        # Per-delegator accounting (SDK Delegation records): a delegator can
        # only withdraw its own bonded stake, never other delegators'.
        held = self.get_delegation(delegator, validator_operator)
        if held < amount:
            raise ValueError(
                f"insufficient delegation: {delegator} has {held} bonded to "
                f"{validator_operator}, requested {amount}"
            )
        v = self.get_validator(validator_operator)
        if v is None or v.tokens < amount:
            raise ValueError("insufficient bonded tokens")
        self._set_delegation(delegator, validator_operator, held - amount)
        v.tokens -= amount
        self.set_validator(v)
        self.bank.send(BONDED_POOL, NOT_BONDED_POOL, amount)
        completion = ctx.block_time + self.unbonding_time
        entries = self.unbonding_entries(delegator, validator_operator)
        entries.append(
            UnbondingEntry(
                creation_height=ctx.block_height,
                completion_time=completion,
                balance=amount,
            )
        )
        self._set_unbonding_entries(delegator, validator_operator, entries)
        queue = self._unbonding_queue()
        queue.append([completion, delegator, validator_operator])
        queue.sort()
        self._set_unbonding_queue(queue)
        self.store.set(
            LAST_UNBONDING_HEIGHT_KEY, ctx.block_height.to_bytes(8, "big")
        )
        for hook in self.hooks:
            hook.after_validator_bond_change(ctx)

    def complete_unbondings(self, ctx) -> int:
        """EndBlocker: pay out matured unbonding entries from the
        not-bonded pool (sdk DequeueAllMatureUBDQueue). The queue index is
        sorted by completion time, so a block with nothing matured costs
        one key read. Returns the number of completed entries."""
        queue = self._unbonding_queue()
        if not queue or queue[0][0] > ctx.block_time:
            return 0
        completed = 0
        matured_pairs = set()
        remaining = []
        for item in queue:
            if item[0] <= ctx.block_time:
                matured_pairs.add((item[1], item[2]))
            else:
                remaining.append(item)
        for delegator, validator in sorted(matured_pairs):
            entries = self.unbonding_entries(delegator, validator)
            keep: list[UnbondingEntry] = []
            for e in entries:
                if e.completion_time <= ctx.block_time:
                    if e.balance > 0:
                        self.bank.send(NOT_BONDED_POOL, delegator, e.balance)
                    completed += 1
                else:
                    keep.append(e)
            self._set_unbonding_entries(delegator, validator, keep)
        self._set_unbonding_queue(remaining)
        return completed

    def last_unbonding_height(self) -> int:
        raw = self.store.get(LAST_UNBONDING_HEIGHT_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def delegations_of(self, delegator: str) -> dict[str, int]:
        """All (validator -> tokens) records of one delegator (gov voting
        power is the voter's own bonded stake)."""
        prefix = DELEGATION_PREFIX + delegator.encode() + b"/"
        return {
            k[len(prefix):].decode(): int.from_bytes(raw, "big")
            for k, raw in self.store.iter_prefix(prefix)
        }

    def delegations_to(self, validator_operator: str) -> dict[str, int]:
        """All (delegator -> tokens) records bonded to one validator."""
        suffix = b"/" + validator_operator.encode()
        out = {}
        for k, raw in self.store.iter_prefix(DELEGATION_PREFIX):
            if k.endswith(suffix):
                delegator = k[len(DELEGATION_PREFIX): -len(suffix)].decode()
                out[delegator] = int.from_bytes(raw, "big")
        return out

    def slash(self, ctx, validator_operator: str, fraction_dec: int) -> int:
        """Burn fraction (Dec-scaled 1e18) of a validator's bonded tokens.

        SDK staking slashes delegations pro-rata via the exchange rate; the
        explicit records here are scaled down directly. Burned tokens leave
        the bonded pool and total supply (ref: staking Keeper.Slash).
        Returns the burned amount."""
        v = self.get_validator(validator_operator)
        if v is None or fraction_dec <= 0:
            return 0
        one = 10**18
        # Unbonding entries are slashed even when bonded stake is zero —
        # otherwise fully-undelegating before evidence lands would let the
        # whole stake mature un-slashed (sdk Slash covers unbonding
        # delegations unconditionally).
        unbonding_burned = self._slash_unbondings(validator_operator, fraction_dec)
        burn_total = v.tokens * fraction_dec // one
        if burn_total <= 0:
            if unbonding_burned:
                for hook in self.hooks:
                    hook.after_validator_bond_change(ctx)
            return unbonding_burned
        # Per-delegation floor cuts first, then distribute the rounding
        # remainder (deterministically, sorted order) so the invariant
        # sum(delegations) == v.tokens survives the slash — otherwise the
        # last delegator to undelegate finds their recorded stake
        # unbacked by the validator total.
        remaining = burn_total
        delegations = self.delegations_to(validator_operator)
        cuts = {}
        for delegator, tokens in sorted(delegations.items()):
            cut = min(tokens * fraction_dec // one, remaining)
            cuts[delegator] = cut
            remaining -= cut
        for delegator, tokens in sorted(delegations.items()):
            if remaining <= 0:
                break
            extra = min(tokens - cuts[delegator], remaining)
            cuts[delegator] += extra
            remaining -= extra
        for delegator, tokens in sorted(delegations.items()):
            self._set_delegation(
                delegator, validator_operator, tokens - cuts[delegator]
            )
        v.tokens -= burn_total
        self.set_validator(v)
        self.bank.burn(BONDED_POOL, burn_total)
        for hook in self.hooks:
            hook.after_validator_bond_change(ctx)
        return burn_total + unbonding_burned

    def _slash_unbondings(self, validator_operator: str, fraction_dec: int) -> int:
        """Slash all outstanding unbonding entries of the validator at the
        same fraction (sdk slashes entries created after the infraction;
        applying it to all entries is strictly no more lenient). Returns
        the burned amount."""
        one = 10**18
        burned = 0
        for delegator, validator, entries in self._iter_unbondings():
            if validator != validator_operator:
                continue
            for e in entries:
                cut = e.balance * fraction_dec // one
                if cut > 0:
                    e.balance -= cut
                    self.bank.burn(NOT_BONDED_POOL, cut)
                    burned += cut
            self._set_unbonding_entries(delegator, validator_operator, entries)
        return burned

    def jail(self, ctx, validator_operator: str) -> None:
        v = self.get_validator(validator_operator)
        if v is not None and not v.jailed:
            v.jailed = True
            self.set_validator(v)
            for hook in self.hooks:
                hook.after_validator_bond_change(ctx)

    def unjail(self, ctx, validator_operator: str) -> None:
        v = self.get_validator(validator_operator)
        if v is not None and v.jailed:
            v.jailed = False
            self.set_validator(v)
            for hook in self.hooks:
                hook.after_validator_bond_change(ctx)


URL_MSG_DELEGATE = "/cosmos.staking.v1beta1.MsgDelegate"
URL_MSG_UNDELEGATE = "/cosmos.staking.v1beta1.MsgUndelegate"


def _staking_msg_fields(m) -> bytes:
    coin = _field_bytes(1, m.denom.encode()) + _field_bytes(2, str(m.amount).encode())
    return (
        _field_bytes(1, m.delegator.encode())
        + _field_bytes(2, m.validator.encode())
        + _field_bytes(3, coin)
    )


def _parse_staking_msg(cls, raw: bytes):
    m = cls("", "", 0)
    for tag, wt, val in _parse_fields(raw):
        if tag == 1:
            _require_wt(wt, 2, tag)
            m.delegator = bytes(val).decode()
        elif tag == 2:
            _require_wt(wt, 2, tag)
            m.validator = bytes(val).decode()
        elif tag == 3:
            _require_wt(wt, 2, tag)
            for t2, w2, v2 in _parse_fields(bytes(val)):
                if t2 == 1:
                    m.denom = bytes(v2).decode()
                elif t2 == 2:
                    m.amount = int(bytes(v2).decode())
    return m


@register_msg(URL_MSG_DELEGATE)
@dataclasses.dataclass
class MsgDelegate:
    delegator: str
    validator: str
    amount: int
    denom: str = "utia"

    def get_signers(self) -> list[str]:
        """ref: staking MsgDelegate.GetSigners — the delegator signs."""
        return [self.delegator]

    marshal = _staking_msg_fields

    @classmethod
    def unmarshal(cls, raw):
        return _parse_staking_msg(cls, raw)

    def validate_basic(self):
        if self.amount <= 0:
            raise ValueError("delegation amount must be positive")


@register_msg(URL_MSG_UNDELEGATE)
@dataclasses.dataclass
class MsgUndelegate:
    delegator: str
    validator: str
    amount: int
    denom: str = "utia"

    def get_signers(self) -> list[str]:
        """ref: staking MsgUndelegate.GetSigners — the delegator signs."""
        return [self.delegator]

    marshal = _staking_msg_fields

    @classmethod
    def unmarshal(cls, raw):
        return _parse_staking_msg(cls, raw)

    def validate_basic(self):
        if self.amount <= 0:
            raise ValueError("undelegation amount must be positive")
