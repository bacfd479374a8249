"""x/mint — Celestia's custom inflation schedule (not the SDK minter).

Reference semantics: x/mint/types/constants.go (8% initial, 10%/yr
disinflation, 1.5% floor), x/mint/types/minter.go (yearly recalculation on
the genesis anniversary), x/mint/abci.go (per-block pro-rata provision
minted to the fee collector).

Decimal arithmetic matches the SDK's 18-digit fixed-point Dec type so the
minted amounts are integer-identical.
"""

from __future__ import annotations

import json

from celestia_tpu_torch.appconsts import BOND_DENOM
from celestia_tpu_torch.x.bank import FEE_COLLECTOR

SECONDS_PER_YEAR = 31_556_952  # 365.2425 days
NANOSECONDS_PER_YEAR = SECONDS_PER_YEAR * 1_000_000_000

ONE = 10**18  # SDK Dec scale
INITIAL_INFLATION_RATE = 80 * 10**15  # 0.080
DISINFLATION_RATE = 100 * 10**15  # 0.100
TARGET_INFLATION_RATE = 15 * 10**15  # 0.015

MINTER_KEY = b"mint/minter"
GENESIS_TIME_KEY = b"mint/genesisTime"


def calculate_inflation_rate(years_since_genesis: int) -> int:
    """Dec-scaled inflation rate after n anniversaries.
    ref: x/mint/types/minter.go:40-53"""
    rate = INITIAL_INFLATION_RATE
    factor = ONE - DISINFLATION_RATE
    for _ in range(years_since_genesis):
        rate = rate * factor // ONE
    if rate < TARGET_INFLATION_RATE:
        return TARGET_INFLATION_RATE
    return rate


class MintKeeper:
    def __init__(self, store, bank):
        self.store = store
        self.bank = bank

    # --- state ---

    def _get(self) -> dict:
        raw = self.store.get(MINTER_KEY)
        if raw is None:
            return {
                "inflation_rate": INITIAL_INFLATION_RATE,
                "annual_provisions": 0,
                "previous_block_time": None,
                "bond_denom": BOND_DENOM,
            }
        return json.loads(raw)

    def _set(self, minter: dict) -> None:
        self.store.set(MINTER_KEY, json.dumps(minter, sort_keys=True).encode())

    def init_genesis(self, genesis_time: float) -> None:
        self.store.set(GENESIS_TIME_KEY, json.dumps(genesis_time).encode())
        self._set(self._get())

    def genesis_time(self) -> float:
        raw = self.store.get(GENESIS_TIME_KEY)
        return json.loads(raw) if raw else 0.0

    def inflation_rate(self) -> float:
        return self._get()["inflation_rate"] / ONE

    # --- BeginBlocker. ref: x/mint/abci.go:14-20 ---

    def begin_blocker(self, ctx) -> None:
        minter = self._get()
        self._maybe_update_minter(ctx, minter)
        self._mint_block_provision(ctx, minter)
        minter["previous_block_time"] = ctx.block_time
        self._set(minter)

    def _maybe_update_minter(self, ctx, minter: dict) -> None:
        """ref: x/mint/abci.go:26-46"""
        elapsed_ns = int((ctx.block_time - self.genesis_time()) * 1e9)
        years = max(elapsed_ns, 0) // NANOSECONDS_PER_YEAR
        new_rate = calculate_inflation_rate(years)
        if new_rate == minter["inflation_rate"] and minter["annual_provisions"] != 0:
            return
        total_supply = self.bank.total_supply(BOND_DENOM)
        minter["inflation_rate"] = new_rate
        # Dec.MulInt: annual provisions stay Dec-scaled (scale 1e18)
        minter["annual_provisions"] = new_rate * total_supply

    def _mint_block_provision(self, ctx, minter: dict) -> None:
        """ref: x/mint/abci.go:49-85"""
        prev = minter["previous_block_time"]
        if prev is None:
            return
        elapsed_ns = int((ctx.block_time - prev) * 1e9)
        if elapsed_ns < 0:
            raise ValueError("current block time before previous block time")
        # blockProvision = annualProvisions * (elapsed / year), truncated
        provision = minter["annual_provisions"] * elapsed_ns // NANOSECONDS_PER_YEAR // ONE
        if provision > 0:
            self.bank.mint(FEE_COLLECTOR, provision)
        ctx.events.append(
            {
                "type": "mint",
                "inflation_rate": minter["inflation_rate"] / ONE,
                "amount": provision,
            }
        )
