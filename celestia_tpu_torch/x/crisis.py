"""x/crisis — invariant registration and checking.

Reference wiring: app/app.go:241-246 (crisis keeper with the registered
module invariants), EndBlocker order app/app.go:476 (crisis first). The
SDK runs registered invariants on demand (MsgVerifyInvariant, the
--inv-check-period flag, and before halting on corruption); this module
registers the framework's cross-module accounting invariants and raises
InvariantBrokenError naming the first violated one.

Registered invariants:
- bank/total-supply: per-denom supply == sum of all account balances
- staking/delegator-shares: validator.tokens == sum of its delegations
- staking/bonded-pool: bonded pool balance == sum of validator tokens
- staking/not-bonded-pool: not-bonded pool balance == sum of
  outstanding unbonding entry balances
"""

from __future__ import annotations

from celestia_tpu_torch.x.bank import (
    BALANCE_PREFIX,
    BONDED_POOL,
    NOT_BONDED_POOL,
    SUPPLY_KEY,
    BankKeeper,
    split_balance_key,
)
from celestia_tpu_torch.x.staking import StakingKeeper, VALIDATOR_PREFIX


class InvariantBrokenError(AssertionError):
    def __init__(self, route: str, msg: str):
        self.route = route
        super().__init__(f"invariant broken ({route}): {msg}")


def bank_total_supply_invariant(store) -> None:
    totals: dict[str, int] = {}
    for key, raw in store.iter_prefix(BALANCE_PREFIX):
        _addr, denom = split_balance_key(key)
        totals[denom] = totals.get(denom, 0) + int.from_bytes(raw, "big")
    supplies: dict[str, int] = {}
    for key, raw in store.iter_prefix(SUPPLY_KEY):
        supplies[key[len(SUPPLY_KEY):].decode()] = int.from_bytes(raw, "big")
    for denom in set(totals) | set(supplies):
        if totals.get(denom, 0) != supplies.get(denom, 0):
            raise InvariantBrokenError(
                "bank/total-supply",
                f"denom {denom}: balances sum {totals.get(denom, 0)} != "
                f"recorded supply {supplies.get(denom, 0)}",
            )


def staking_delegator_shares_invariant(store) -> None:
    import json

    staking = StakingKeeper(store, BankKeeper(store))
    for _key, raw in store.iter_prefix(VALIDATOR_PREFIX):
        v = json.loads(raw)
        delegated = sum(staking.delegations_to(v["operator"]).values())
        if delegated != v["tokens"]:
            raise InvariantBrokenError(
                "staking/delegator-shares",
                f"validator {v['operator']}: delegations sum {delegated} "
                f"!= tokens {v['tokens']}",
            )


def staking_bonded_pool_invariant(store) -> None:
    import json

    bank = BankKeeper(store)
    total = sum(
        json.loads(raw)["tokens"]
        for _k, raw in store.iter_prefix(VALIDATOR_PREFIX)
    )
    pool = bank.get_balance(BONDED_POOL)
    if pool != total:
        raise InvariantBrokenError(
            "staking/bonded-pool",
            f"bonded pool holds {pool}, validators record {total}",
        )


def staking_not_bonded_pool_invariant(store) -> None:
    import json

    from celestia_tpu_torch.x.staking import UNBONDING_PREFIX

    bank = BankKeeper(store)
    total = 0
    for _k, raw in store.iter_prefix(UNBONDING_PREFIX):
        total += sum(e["balance"] for e in json.loads(raw))
    pool = bank.get_balance(NOT_BONDED_POOL)
    if pool != total:
        raise InvariantBrokenError(
            "staking/not-bonded-pool",
            f"not-bonded pool holds {pool}, unbonding entries record {total}",
        )


INVARIANTS = (
    ("bank/total-supply", bank_total_supply_invariant),
    ("staking/delegator-shares", staking_delegator_shares_invariant),
    ("staking/bonded-pool", staking_bonded_pool_invariant),
    ("staking/not-bonded-pool", staking_not_bonded_pool_invariant),
)


class CrisisKeeper:
    def __init__(self, store):
        self.store = store

    def assert_invariants(self) -> None:
        """Run every registered invariant; raise on the first violation
        (sdk AssertInvariants — app/export.go:69 runs this before a
        zero-height export)."""
        for _route, fn in INVARIANTS:
            fn(self.store)

    def check_invariant(self, route: str) -> None:
        """MsgVerifyInvariant analogue: run one invariant by route."""
        for r, fn in INVARIANTS:
            if r == route:
                fn(self.store)
                return
        raise ValueError(f"unknown invariant route {route}")
