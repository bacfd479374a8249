"""The measured routing tables of the port (port of the JAX package's
app/calibration.py): the App's backend crossover and the dense/XOR table.

The backend crossover. ``App.resolve_extend_backend`` routes ``auto`` by
the measured winner per k between the card (``gpu``) and the native C++
runtime (``native``): ``measure_crossover`` times the proposal path's unit
of work (square bytes in, the DAH's axis roots out, transfers included) on
each available backend at a ladder of k, and ``load_default_table`` reads
the port's own committed table, ``celestia_tpu_torch/config/crossover.json``
(written by ``python3 chip_smoke.py --crossover-out PATH`` on the card).
The JAX package's ``config/crossover.json`` holds TPU times and is never
read here. With no table the App falls back to its static gate.

The dense/XOR table. ``extend._xor_active`` asks ``xor_winner(k)`` which
contraction the extend should use when no env pin decides: the dense GF(2)
product (K1/K4) or the compiled XOR schedule (K5/K6). Both give the same bytes, so the
choice is one of speed, and it is read from a table of times measured on
the card: ``celestia_tpu_torch/config/xor_schedule.json``, the port's own
file. The JAX package's ``config/xor_schedule.json`` holds TPU times and is
never read here. With no table, or an empty one, the winner is dense.

The table's format is the JAX package's ``CrossoverTable`` JSON: per-k
times in ms per spelling, e.g.
``{"entries": {"64": {"dense": 2.1, "xor": 1.9}}, "measured_at": ...}``,
plus the card's name and power limit as nvidia-smi reports them. The port's
times are device times: one extend's three encode launches on the fused
route (K1 or K5, the only kernels in which the fused routes differ), and a
rung enters the table only where the two spellings' launch times do not
overlap (``xor_table_from_launches``). ``python3 chip_smoke.py
--xor-table-out PATH`` writes it from the profiler's records of each
launch; ``measure_xor_crossover`` (the JAX package's name, at
``XOR_DEFAULT_KS``) takes the same launches' times with CUDA events, for
an operator's check on any card, and writes no file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import time

import numpy as np

from celestia_tpu_torch.appconsts import SHARE_SIZE
from celestia_tpu_torch.log import logger

log = logger("calibration")

# every power of two to the largest square: the small squares are the
# common block, so the table measures them rather than extrapolating to
# them from k = 16 (the JAX package's ladder starts at 16)
DEFAULT_KS = (1, 2, 4, 8, 16, 32, 64, 128)
FILENAME = "crossover.json"
CROSSOVER_TABLE_PATH = pathlib.Path(__file__).resolve().parents[1] / "config" / FILENAME
XOR_FILENAME = "xor_schedule.json"
XOR_DEFAULT_KS = (32, 64)
XOR_TABLE_PATH = pathlib.Path(__file__).resolve().parents[1] / "config" / XOR_FILENAME


@dataclasses.dataclass
class CrossoverTable:
    """Per-k times (ms) per backend or spelling, e.g.
    {64: {"gpu": 1.2, "native": 95.1}} or {64: {"dense": 2.1, "xor": 1.9}},
    with the card they were taken on."""

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

    def save(self, path: str | pathlib.Path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_json(), indent=2) + "\n")

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "CrossoverTable | None":
        """None when the file is missing or unreadable: an absent or
        corrupt table means unmeasured, and the route stays dense."""
        try:
            return cls.from_json(json.loads(pathlib.Path(path).read_text()))
        except (OSError, ValueError, TypeError, AttributeError):
            return None


def crossover_path(home: str | pathlib.Path) -> pathlib.Path:
    """A node home's measured backend table (``cli start`` loads it, and
    ``--calibrate-crossover`` writes it): ``<home>/config/crossover.json``,
    the config directory of ``config.config_dir`` spelled out."""
    return pathlib.Path(home) / "config" / FILENAME


_default_table: "CrossoverTable | None" = None
_default_loaded = False


def load_default_table() -> "CrossoverTable | None":
    """The port's committed backend table (``CROSSOVER_TABLE_PATH``), which
    every fresh App attaches; ``App.calibrate_crossover()`` (or assigning
    ``App.crossover``) overrides it, and the App re-checks each
    winner against the backends it has. Loaded once per process; None when
    absent or corrupt. The file carries ``measured_at`` 0, as the JAX
    package's does: a committed default is never stale to the readiness
    check (``slo.readiness``); its ``card`` and ``power_limit`` say where it
    was measured."""
    global _default_table, _default_loaded
    if not _default_loaded:
        _default_table = CrossoverTable.load(CROSSOVER_TABLE_PATH)
        _default_loaded = True
    return _default_table


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


def xor_table_from_launches(per_launch: dict[int, dict[str, list[float]]],
                            measured_at: float, card: str = "",
                            power_limit: str = "") -> tuple[CrossoverTable, dict]:
    """The dense/XOR routing table from the per-launch device ms of the two
    fused encode kernels per k (``{k: {"dense": [K1 ms...], "xor": [K5
    ms...]}}``). A rung's time per spelling is one extend's three encode
    launches, 3 x their mean. A rung enters the table only where the two
    spellings' launches do not overlap (the faster's slowest below the
    slower's fastest); the lookup takes the nearest rung for the others.
    Returns (the table, every rung's times with ``resolved`` and each
    spelling's launch range)."""
    table = CrossoverTable({}, measured_at, card, power_limit)
    rungs = {}
    for k, launches in sorted(per_launch.items()):
        d, x = launches["dense"], launches["xor"]
        entry = {"dense": 3 * float(np.mean(d)), "xor": 3 * float(np.mean(x))}
        resolved = max(d) < min(x) or max(x) < min(d)
        if resolved:
            table.entries[k] = entry
        rungs[k] = {**entry, "resolved": resolved,
                    "dense_launch_range_ms": [min(d), max(d)],
                    "xor_launch_range_ms": [min(x), max(x)]}
    return table, rungs


def _launch_ms(call, launches: int) -> list[float]:
    """Device ms of each of ``launches`` back-to-back calls of ``call`` (one
    kernel launch each), by CUDA events between them. The card sleeps while
    the host queues them, so no launch waits on the host."""
    import torch

    call()  # the build and the first launch stay out of the times
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(launches + 1)]
    torch.cuda._sleep(10_000_000)
    for mark in marks[:-1]:
        mark.record()
        call()
    marks[-1].record()
    marks[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def measure_xor_crossover(ks: tuple[int, ...] = XOR_DEFAULT_KS,
                          device=None) -> CrossoverTable:
    """The dense/XOR table on ``device`` (None means CUDA; the card only):
    per k, a random square's fused encode on K1 (dense) and on K5 (xor),
    10 launches each timed by CUDA events, through
    ``xor_table_from_launches``, the rule of the committed table. The
    table holds the resolved rungs; the log has every rung's times."""
    import torch

    from celestia_tpu_torch import device as device_mod
    from celestia_tpu_torch.ops import rs, rs_cuda, xor_cuda

    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        raise ValueError("measure_xor_crossover times the card's kernels: "
                         f"it needs a CUDA device, not {dev}")
    per_launch = {}
    for k in ks:
        rng = np.random.default_rng(k)
        x = torch.from_numpy(rng.integers(0, 256, size=(k, k * SHARE_SIZE),
                                          dtype=np.uint8)).to(dev)
        m2, ops = rs.encode_matrix(k, dev), xor_cuda.schedule_operands(k, dev)
        per_launch[k] = {
            "dense": _launch_ms(lambda: rs_cuda.encode2d_hash(x, m2), 10),
            "xor": _launch_ms(lambda: xor_cuda.encode2d_xor_hash(x, ops), 10),
        }
    table, rungs = xor_table_from_launches(per_launch, time.time(),
                                           torch.cuda.get_device_name(dev))
    for k, rung in rungs.items():
        log.info("xor crossover rung", k=k, dense=round(rung["dense"], 4),
                 xor=round(rung["xor"], 4), resolved=rung["resolved"])
    return table


def _best_of(fn, repeats: int) -> float:
    """Best-of wall ms after one untimed warmup (which absorbs the kernel
    build and first-launch costs)."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def measure_crossover(ks: tuple[int, ...] = DEFAULT_KS, repeats: int = 2,
                      device=None) -> CrossoverTable:
    """Time the proposal path's unit of work (square bytes in, the DAH's
    axis roots out, transfers included) per available backend per k:
    ``gpu`` is ``extend.roots_device`` on ``device`` (None means CUDA; it is
    timed only on a CUDA device) and ``native`` the C++ runtime.

    Share bytes are random: the roots cost nothing more for any content.
    The plain host path is not timed: the resolver falls back to it only
    when neither backend is there, and timing its k = 128 extend would stall
    a start."""
    import torch

    from celestia_tpu_torch import device as device_mod
    from celestia_tpu_torch import native
    from celestia_tpu_torch.ops import extend

    dev = device_mod.resolve(device)
    entries: dict[int, dict[str, float]] = {}
    for k in ks:
        rng = np.random.default_rng(k)
        arr = rng.integers(0, 256, size=(k, k, SHARE_SIZE), dtype=np.uint8)
        timings: dict[str, float] = {}
        if dev.type == "cuda":
            timings["gpu"] = _best_of(lambda: extend.roots_device(arr, dev), repeats)
        if native.available():
            timings["native"] = _best_of(lambda: native.extend_and_root_native(arr), repeats)
        if timings:
            entries[k] = timings
            log.info("crossover rung", k=k, **{b: round(ms, 3) for b, ms in timings.items()})
    # the caller adds the power limit (nvidia-smi's), which torch cannot read
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    return CrossoverTable(entries, measured_at=time.time(), card=card)
