"""Execution context + gas metering for message handling.

The reference threads sdk.Context (block info, gas meter, exec mode,
events) through the ante chain and keepers; this is the same object in
explicit form.
"""

from __future__ import annotations

import dataclasses
import enum


class OutOfGasError(Exception):
    pass


class GasMeter:
    def __init__(self, limit: int | None):
        self.limit = limit  # None = infinite (block processing internals)
        self.consumed = 0

    def consume(self, amount: int, descriptor: str = "") -> None:
        if amount < 0:
            raise ValueError("negative gas")
        self.consumed += amount
        if self.limit is not None and self.consumed > self.limit:
            raise OutOfGasError(
                f"out of gas in {descriptor}: limit {self.limit}, consumed {self.consumed}"
            )

    def remaining(self) -> int:
        if self.limit is None:
            return 2**63
        return max(self.limit - self.consumed, 0)


class ExecMode(enum.Enum):
    CHECK = "check"
    RECHECK = "recheck"
    PREPARE = "prepare"
    PROCESS = "process"
    DELIVER = "deliver"
    SIMULATE = "simulate"


@dataclasses.dataclass
class Context:
    store: object  # CacheStore branch
    chain_id: str
    block_height: int
    block_time: float
    app_version: int
    mode: ExecMode
    gas_meter: GasMeter = dataclasses.field(default_factory=lambda: GasMeter(None))
    events: list = dataclasses.field(default_factory=list)
    min_gas_price: float = 0.0
    priority: int = 0

    def is_check_tx(self) -> bool:
        return self.mode in (ExecMode.CHECK, ExecMode.RECHECK)

    def is_recheck_tx(self) -> bool:
        return self.mode == ExecMode.RECHECK

    def with_gas_meter(self, limit: int | None) -> "Context":
        return dataclasses.replace(self, gas_meter=GasMeter(limit))
