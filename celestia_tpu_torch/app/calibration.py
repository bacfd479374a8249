"""The measured dense/XOR routing table (port of the XOR part of the JAX
package's app/calibration.py).

``extend._xor_active`` asks ``xor_winner(k)`` which contraction the
extend should use when no env pin decides: the dense GF(2) product (K1/K4)
or the compiled XOR schedule (K5/K6). Both give the same bytes, so the
choice is one of speed, and it is read from a table of times measured on
the card: ``celestia_tpu_torch/config/xor_schedule.json``, the port's own
file. The JAX package's ``config/xor_schedule.json`` holds TPU times and is
never read here. With no table, or an empty one, the winner is dense.

The table's format is the JAX package's ``CrossoverTable`` JSON: per-k
times in ms per spelling, e.g.
``{"entries": {"64": {"dense": 2.1, "xor": 1.9}}, "measured_at": ...}``,
plus the card's name and power limit as nvidia-smi reports them. The port's
times are device times: one extend's three encode launches on the fused
route (K1 or K5, the only kernels in which the fused routes differ), written
by ``python3 chip_smoke.py --xor-table-out PATH``, which keeps only the k at
which the two spellings' launch times do not overlap.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib

XOR_FILENAME = "xor_schedule.json"
XOR_TABLE_PATH = pathlib.Path(__file__).resolve().parents[1] / "config" / XOR_FILENAME


@dataclasses.dataclass
class CrossoverTable:
    """Per-k times (ms) per spelling, e.g.
    {64: {"dense": 2.1, "xor": 1.9}}, with the card they were taken on."""

    entries: dict[int, dict[str, float]]
    measured_at: float = 0.0
    card: str = ""
    power_limit: str = ""

    def winner(self, k: int) -> str | None:
        """Measured fastest spelling for a k×k square, or None when the
        table is empty. Unmeasured k use the nearest measured rung in log2
        distance; ties go to the smaller rung."""
        if not self.entries:
            return None
        target = math.log2(max(1, k))
        best_k = min(self.entries, key=lambda m: (abs(math.log2(m) - target), m))
        timings = self.entries[best_k]
        if not timings:
            return None
        return min(timings, key=lambda b: timings[b])

    def to_json(self) -> dict:
        return {
            "entries": {str(k): dict(v) for k, v in sorted(self.entries.items())},
            "measured_at": self.measured_at,
            "card": self.card,
            "power_limit": self.power_limit,
        }

    @classmethod
    def from_json(cls, d: dict) -> "CrossoverTable":
        return cls(
            entries={int(k): {str(b): float(ms) for b, ms in v.items()}
                     for k, v in d.get("entries", {}).items()},
            measured_at=float(d.get("measured_at", 0.0)),
            card=str(d.get("card", "")),
            power_limit=str(d.get("power_limit", "")),
        )

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "CrossoverTable | None":
        """None when the file is missing or unreadable: an absent or
        corrupt table means unmeasured, and the route stays dense."""
        try:
            return cls.from_json(json.loads(pathlib.Path(path).read_text()))
        except (OSError, ValueError, TypeError, AttributeError):
            return None


_xor_table: "CrossoverTable | None" = None
_xor_loaded = False


def load_xor_table() -> "CrossoverTable | None":
    """The port's committed table (``XOR_TABLE_PATH``), loaded once per
    process; None when absent or corrupt."""
    global _xor_table, _xor_loaded
    if not _xor_loaded:
        _xor_table = CrossoverTable.load(XOR_TABLE_PATH)
        _xor_loaded = True
    return _xor_table


def xor_winner(k: int) -> str:
    """Measured winner ("dense" or "xor") at square size k. Dense when the
    table is absent or empty: the schedule only routes on a measurement
    that says it is faster."""
    table = load_xor_table()
    if table is None:
        return "dense"
    return table.winner(k) or "dense"
