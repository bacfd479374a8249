"""Open-loop load metering — coordinated-omission-free latency.

A closed-loop client (the `das`/`pfb` drivers in world.py) sends, waits
for the reply, then sends again: when the server slows down, the client
slows down with it, and the latency histogram silently omits exactly
the intervals where the server was in trouble. That is coordinated
omission.

The `open_das` driver avoids it by scheduling arrivals from a seeded
Poisson process on an ABSOLUTE clock — the intended send times are
fixed before the run — and measuring each request's latency from its
*intended* send time, not from when the (serial) client got around to
issuing it. Queue buildup is thereby charged to the server: if a reply
takes 1 s, the next nine arrivals that were due during that second all
carry the backlog in their recorded latency.

`OpenLoadMeter` aggregates per-phase: offered vs completed counts and
an intended-basis latency histogram, yielding a latency-vs-offered-load
curve across a stepped sweep. `detect_knee` finds the first step where
the system stops keeping up (goodput collapse or p99 blow-up) and
declares the knee at the step before it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from celestia_tpu_torch import telemetry

# A step "keeps up" while goodput >= this fraction of the offered rate.
DEFAULT_GOODPUT_FLOOR = 0.9
# ... and while p99 stays under this multiple of the first step's p99.
DEFAULT_P99_BLOWUP = 3.0


@dataclass
class PhaseLoad:
    """One sweep step: counts + intended-basis latency histogram."""

    phase: str
    planned_hz: float
    offered: int = 0
    done: int = 0
    ok: int = 0
    t0: float = 0.0
    t1: float = 0.0
    hist: telemetry.Histogram = field(default_factory=telemetry.Histogram)

    def snapshot(self) -> dict:
        span = max(1e-9, self.t1 - self.t0)
        q = {p: (self.hist.quantile(p / 100.0) if self.hist.count else 0.0)
             for p in (50, 90, 99)}
        return {
            "phase": self.phase,
            "planned_hz": round(self.planned_hz, 3),
            "offered": self.offered,
            "done": self.done,
            "ok": self.ok,
            "offered_hz": round(self.offered / span, 3),
            "goodput_hz": round(self.ok / span, 3),
            "p50_s": q[50], "p90_s": q[90], "p99_s": q[99],
        }


class OpenLoadMeter:
    """Thread-safe per-phase aggregation for open-loop drivers.

    The engine calls `begin_phase` at each phase boundary; every
    `open_das` client thread calls `note(latency)` with the
    intended-send-time basis latency. `curve()` renders the sweep as a
    list of step snapshots ordered by planned offered rate (the
    monotone offered-load axis the report asserts)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._phases: list[PhaseLoad] = []
        self._current: PhaseLoad | None = None

    def begin_phase(self, phase: str, planned_hz: float, now: float) -> None:
        with self._lock:
            if self._current is not None:
                self._current.t1 = now
            self._current = PhaseLoad(phase=phase, planned_hz=planned_hz,
                                      t0=now, t1=now)
            self._phases.append(self._current)

    def end(self, now: float) -> None:
        with self._lock:
            if self._current is not None:
                self._current.t1 = now
                self._current = None

    def note_offered(self, n: int = 1) -> None:
        """Count an arrival at its SCHEDULED time — offered load is
        intent, so a backlog at phase end still counts against the
        step's goodput ratio instead of vanishing."""
        with self._lock:
            if self._current is not None:
                self._current.offered += n

    def note(self, latency_s: float, ok: bool) -> None:
        """Count a completion with its intended-send-time latency."""
        with self._lock:
            cur = self._current
            if cur is None:
                return
            cur.done += 1
            if ok:
                cur.ok += 1
            cur.hist.observe(max(0.0, latency_s))

    def curve(self) -> list[dict]:
        with self._lock:
            steps = [p.snapshot() for p in self._phases if p.offered > 0]
        steps.sort(key=lambda s: s["planned_hz"])
        return steps


def detect_knee(steps: list[dict],
                goodput_floor: float = DEFAULT_GOODPUT_FLOOR,
                p99_blowup: float = DEFAULT_P99_BLOWUP) -> dict:
    """Find the load knee in a sweep's step list (ordered by offered
    rate). A step is 'degraded' when goodput falls below
    `goodput_floor` x offered, or p99 exceeds `p99_blowup` x the first
    step's p99. The knee is the last healthy step before the first
    degraded one; a sweep with no degraded step reports its top step
    (knee not reached)."""
    if not steps:
        return {"found": False, "reason": "no steps"}
    base_p99 = steps[0].get("p99_s") or 0.0
    for i, s in enumerate(steps):
        offered_hz = s.get("offered_hz") or 0.0
        goodput_hz = s.get("goodput_hz") or 0.0
        p99 = s.get("p99_s") or 0.0
        degraded = (offered_hz > 0
                    and goodput_hz < goodput_floor * offered_hz)
        if base_p99 > 0 and p99 > p99_blowup * base_p99:
            degraded = True
        if degraded:
            if i == 0:
                return {"found": True, "knee_index": 0,
                        "knee_hz": goodput_hz, "degraded_index": 0,
                        "reason": "degraded at first step"}
            prev = steps[i - 1]
            return {"found": True, "knee_index": i - 1,
                    "knee_hz": prev["goodput_hz"], "degraded_index": i,
                    "reason": "goodput/p99 degradation"}
    top = steps[-1]
    return {"found": False, "knee_index": len(steps) - 1,
            "knee_hz": top["goodput_hz"],
            "reason": "knee not reached within sweep"}
