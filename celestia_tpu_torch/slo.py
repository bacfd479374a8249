"""SLO engine: declarative objectives evaluated from live telemetry (port
of the JAX package's slo.py).

A small set of declarative objectives is evaluated in-process, on demand,
from the histogram and counter state of ``telemetry.metrics``: no scrape
loop, no background thread. The results feed the node's ``/readyz`` and
``/debug/slo`` routes (node/rpc.py), and every ok -> breach transition is
one structured log event, one ``slo_breach_total`` bump and one
zero-duration ``slo.breach`` span in the flight recorder.

Objective kinds:

    ratio        good/total counter pair against an availability target,
                 judged by multi-window burn rate: burn = error_rate /
                 error_budget must exceed the window's threshold in both a
                 long and a short window.
    quantile     a latency quantile of one histogram family (every label
                 set merged; the buckets are shared, so the merge is
                 exact) against a ceiling in seconds.
    counter_max  a cumulative counter against a ceiling (any sticky
                 device disable is a breach until an operator acts).

Counters are cumulative, so windowed rates need history: the engine keeps a
bounded deque of (t, counters) snapshots, one a ``evaluate()`` call.

The port's App says ``gpu`` where the JAX App says ``tpu``, so the sticky
objective is ``gpu_not_sticky_disabled`` over ``extend_gpu_disabled_total``
and the readiness detail texts say ``gpu``; the readiness check names are
the JAX package's, which load balancers and the fleet supervisor read.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from celestia_tpu_torch.log import logger

log = logger("slo")

# (long_window_s, short_window_s, max_burn_rate): page-worthy fast burn
# plus a slow burn, scaled down from the SRE-book hours to minutes —
# this node's lifetime is a session, not a quarter (specs/slo.md).
DEFAULT_WINDOWS = ((300.0, 60.0, 14.4), (3600.0, 300.0, 6.0))

# a crossover table (app/calibration.py) older than this is stale: the
# tunnel/hardware it measured may no longer exist. measured_at == 0
# means "no timestamp recorded" (hand-built tables) and never expires.
CROSSOVER_MAX_AGE_S = 7 * 24 * 3600.0


@dataclasses.dataclass
class Objective:
    """One declarative objective. Exactly the fields its kind reads."""

    name: str
    kind: str  # "ratio" | "quantile" | "counter_max"
    # ratio
    good: str | None = None
    total: str | None = None
    target: float = 0.999
    windows: tuple = DEFAULT_WINDOWS
    # quantile
    metric: str | None = None
    q: float = 0.99
    limit_s: float = 1.0
    # counter_max
    counter: str | None = None
    limit: float = 0.0

    def __post_init__(self):
        if self.kind not in ("ratio", "quantile", "counter_max"):
            raise ValueError(f"unknown objective kind {self.kind!r}")


def default_objectives() -> list[Objective]:
    """The node's shipped objective set (specs/slo.md)."""
    return [
        # black-box availability: the synthetic prober (node/prober.py)
        # is the ONLY writer of these counters, so this objective is
        # end-to-end truth about the serve path, not self-reporting
        Objective(name="sample_availability", kind="ratio",
                  good="probe_sample_ok_total",
                  total="probe_sample_total", target=0.999),
        # extend latency: p99 over every extend_block label set. The
        # ceiling is generous (CPU-host baseline headroom) — it exists
        # to catch degradation-to-pathological, not to grade the card.
        Objective(name="extend_block_p99", kind="quantile",
                  metric="extend_block", q=0.99, limit_s=2.5),
        # sticky device disable is an SLO breach by definition: the node
        # is serving, but on the wrong hardware, until an operator
        # intervenes (specs/observability.md degradation strikes)
        Objective(name="gpu_not_sticky_disabled", kind="counter_max",
                  counter="extend_gpu_disabled_total", limit=0.0),
        # silent data corruption: ANY detected flip — device extend or
        # repair output, transfer chunk — is a breach (ADR-015). The
        # node keeps serving host-recomputed results, but a machine
        # that produced one wrong answer is operator-attention-worthy.
        Objective(name="sdc_detected", kind="counter_max",
                  counter="sdc_detected_total", limit=0.0),
        # admission ratio (shed-ratio ceiling, ADR-016): shedding is
        # the CORRECT overload response, but sustained shedding of
        # >10% of dispatch attempts means the node is underprovisioned
        # for its traffic — burn-rate alerting on the admitted/total
        # ratio pages before clients give up. Both counters are
        # written only by the device dispatcher (node/dispatch.py).
        Objective(name="rpc_admission", kind="ratio",
                  good="rpc_dispatch_admitted_total",
                  total="rpc_dispatch_total", target=0.9),
        # durable-store integrity (ADR-021): a page/DAH/levels record
        # whose CRC failed on read means data rotted ON DISK (or a
        # torn write escaped the atomic-rename contract). The read was
        # refused — no torn bytes served — but any occurrence is a
        # breach: the store exists so restarts can TRUST it.
        Objective(name="store_integrity", kind="counter_max",
                  counter="store_read_corrupt_total", limit=0.0),
        # durable-store writability (ADR-026): the store flipping to
        # sticky read-only (ENOSPC, real or injected) is GRACEFUL —
        # reads keep serving from every tier — but the node is no
        # longer extending its durable history, so any entry into the
        # degraded state must surface on the SLO board. The counter is
        # written only by BlockStore._enter_read_only.
        Objective(name="store_writable", kind="counter_max",
                  counter="store_read_only_total", limit=0.0),
    ]


class SloEngine:
    """Evaluates objectives against a telemetry Registry on demand."""

    MAX_SNAPSHOTS = 256  # ~4h of history at a 1-minute scrape cadence

    def __init__(self, objectives: list[Objective] | None = None,
                 registry=None, clock=time.monotonic):
        if registry is None:
            from celestia_tpu_torch.telemetry import metrics as registry
        self.registry = registry
        self.objectives = (objectives if objectives is not None
                           else default_objectives())
        self._clock = clock
        # (t, {counter_key: value}) — only the keys ratio objectives
        # read, so a snapshot is O(objectives), not O(all counters)
        self._snaps: collections.deque = collections.deque(
            maxlen=self.MAX_SNAPSHOTS
        )
        self._breached: dict[str, bool] = {}

    # -- snapshots ----------------------------------------------------- #

    def _counter_keys(self) -> list[str]:
        keys = []
        for o in self.objectives:
            if o.kind == "ratio":
                keys += [o.good, o.total]
        return keys

    def _snapshot(self, now: float) -> dict:
        snap = {k: self.registry.get_counter(k) for k in self._counter_keys()}
        self._snaps.append((now, snap))
        return snap

    def _window_delta(self, now: float, window: float, key: str,
                      current: float) -> float | None:
        """Counter increase over the trailing window: diff against the
        newest snapshot at least ``window`` old, else the OLDEST one
        (short history ⇒ the window is "since engine start"). None when
        there is no prior snapshot at all."""
        past = None
        for t, snap in self._snaps:
            if now - t >= window:
                past = snap  # keep scanning: newest old-enough wins
            else:
                break
        if past is None and self._snaps:
            past = self._snaps[0][1]
        if past is None:
            return None
        return current - past.get(key, 0.0)

    # -- evaluation ---------------------------------------------------- #

    def _eval_ratio(self, o: Objective, now: float) -> dict:
        good = self.registry.get_counter(o.good)
        total = self.registry.get_counter(o.total)
        budget = 1.0 - o.target
        windows = []
        burning = []
        for long_w, short_w, max_burn in o.windows:
            rates = []
            for w in (long_w, short_w):
                dt_total = self._window_delta(now, w, o.total, total)
                dt_good = self._window_delta(now, w, o.good, good)
                if not dt_total:  # no traffic in window: cannot burn
                    rates.append(None)
                    continue
                err = max(0.0, dt_total - (dt_good or 0.0)) / dt_total
                rates.append(err / budget if budget > 0 else float("inf"))
            fired = all(r is not None and r >= max_burn for r in rates)
            windows.append({
                "long_s": long_w, "short_s": short_w, "max_burn": max_burn,
                "burn_long": rates[0], "burn_short": rates[1],
                "breaching": fired,
            })
            burning.append(fired)
        ratio = (good / total) if total else None
        return {
            "name": o.name, "kind": "ratio", "target": o.target,
            "good": good, "total": total, "ratio_overall": ratio,
            "windows": windows,
            "ok": not any(burning),
        }

    def _merged_hist(self, metric: str):
        """All label sets of one histogram family merged bucketwise —
        exact, because bounds are registry-wide (ADR-013)."""
        merged = None
        for _labels, hist in self.registry.histogram_family(metric):
            if merged is None:
                from celestia_tpu_torch.telemetry import Histogram

                merged = Histogram(hist.bounds)
            for i, c in enumerate(hist.counts):
                merged.counts[i] += c
            merged.sum += hist.sum
            merged.count += hist.count
        return merged

    def _eval_quantile(self, o: Objective, _now: float) -> dict:
        merged = self._merged_hist(o.metric)
        if merged is None or merged.count == 0:
            return {"name": o.name, "kind": "quantile", "q": o.q,
                    "limit_s": o.limit_s, "value_s": None, "count": 0,
                    "ok": True}  # no observations: nothing to judge
        value = merged.quantile(o.q)
        return {"name": o.name, "kind": "quantile", "q": o.q,
                "limit_s": o.limit_s, "value_s": value,
                "count": merged.count, "ok": value <= o.limit_s}

    def _eval_counter_max(self, o: Objective, _now: float) -> dict:
        value = self.registry.get_counter(o.counter)
        return {"name": o.name, "kind": "counter_max",
                "counter": o.counter, "value": value, "limit": o.limit,
                "ok": value <= o.limit}

    def evaluate(self, now: float | None = None) -> dict:
        """One evaluation pass: snapshot counters, judge every
        objective, emit breach/recovery transitions."""
        now = self._clock() if now is None else now
        self._snapshot(now)
        results = []
        for o in self.objectives:
            res = {
                "ratio": self._eval_ratio,
                "quantile": self._eval_quantile,
                "counter_max": self._eval_counter_max,
            }[o.kind](o, now)
            self._transition(o.name, res)
            results.append(res)
        return {
            "ok": all(r["ok"] for r in results),
            "objectives": results,
            "snapshots": len(self._snaps),
        }

    # -- windowed verdicts (specs/slo.md, scenarios) -------------------- #

    def capture(self) -> dict:
        """Freeze one end of an ``evaluate_at`` window: every counter
        the objectives read plus the bucket state of every quantile
        metric. Pure read — no snapshot deque append, no transitions —
        so a scenario engine can bracket each load phase without
        perturbing the burn-rate history ``evaluate()`` maintains."""
        counters: dict[str, float] = {}
        hists: dict[str, tuple] = {}
        for o in self.objectives:
            if o.kind == "ratio":
                for k in (o.good, o.total):
                    counters[k] = self.registry.get_counter(k)
            elif o.kind == "counter_max":
                counters[o.counter] = self.registry.get_counter(o.counter)
            elif o.kind == "quantile":
                merged = self._merged_hist(o.metric)
                if merged is not None:
                    hists[o.metric] = (tuple(merged.counts), merged.sum,
                                       merged.count, tuple(merged.bounds))
        return {"t": self._clock(), "counters": counters, "hists": hists}

    def evaluate_at(self, window: tuple[dict, dict]) -> dict:
        """Judge every objective over one bracketed window — a pair of
        ``capture()`` results — instead of whole-process history.

        Window semantics per kind: a *ratio* objective is judged on the
        good/total counter DELTAS (the in-window error rate vs the
        error budget; no in-window traffic is a pass with ratio None);
        a *quantile* objective on the bucketwise histogram DIFF (the
        distribution of only the in-window observations); a
        *counter_max* objective on the counter INCREASE vs its limit
        (e.g. sdc_detected limit 0: any in-window detection breaches,
        regardless of detections before the window). No breach
        transitions are emitted — this is a verdict snapshot, not the
        alerting path."""
        start, end = window
        results = [
            {
                "ratio": self._eval_ratio_window,
                "quantile": self._eval_quantile_window,
                "counter_max": self._eval_counter_max_window,
            }[o.kind](o, start, end)
            for o in self.objectives
        ]
        return {
            "ok": all(r["ok"] for r in results),
            "window_s": end["t"] - start["t"],
            "objectives": results,
        }

    @staticmethod
    def _delta(start: dict, end: dict, key: str) -> float:
        return (end["counters"].get(key, 0.0)
                - start["counters"].get(key, 0.0))

    def _eval_ratio_window(self, o: Objective, start: dict,
                           end: dict) -> dict:
        d_total = self._delta(start, end, o.total)
        d_good = self._delta(start, end, o.good)
        budget = 1.0 - o.target
        if d_total <= 0:
            return {"name": o.name, "kind": "ratio", "target": o.target,
                    "good": d_good, "total": d_total, "ratio": None,
                    "burn": None, "ok": True}
        err = max(0.0, d_total - d_good) / d_total
        ratio = d_good / d_total
        burn = err / budget if budget > 0 else float("inf")
        return {"name": o.name, "kind": "ratio", "target": o.target,
                "good": d_good, "total": d_total, "ratio": ratio,
                "burn": burn, "ok": ratio >= o.target}

    def _eval_quantile_window(self, o: Objective, start: dict,
                              end: dict) -> dict:
        from celestia_tpu_torch.telemetry import Histogram

        e = end["hists"].get(o.metric)
        if e is None:
            return {"name": o.name, "kind": "quantile", "q": o.q,
                    "limit_s": o.limit_s, "value_s": None, "count": 0,
                    "ok": True}
        s = start["hists"].get(o.metric)
        diff = Histogram(list(e[3]))
        s_counts = s[0] if s is not None else (0,) * len(e[0])
        diff.counts = [ec - sc for ec, sc in zip(e[0], s_counts)]
        diff.sum = e[1] - (s[1] if s is not None else 0.0)
        diff.count = e[2] - (s[2] if s is not None else 0)
        if diff.count <= 0:
            return {"name": o.name, "kind": "quantile", "q": o.q,
                    "limit_s": o.limit_s, "value_s": None, "count": 0,
                    "ok": True}
        value = diff.quantile(o.q)
        return {"name": o.name, "kind": "quantile", "q": o.q,
                "limit_s": o.limit_s, "value_s": value,
                "count": diff.count, "ok": value <= o.limit_s}

    def _eval_counter_max_window(self, o: Objective, start: dict,
                                 end: dict) -> dict:
        delta = self._delta(start, end, o.counter)
        return {"name": o.name, "kind": "counter_max",
                "counter": o.counter, "value": delta, "limit": o.limit,
                "ok": delta <= o.limit}

    def _transition(self, name: str, res: dict) -> None:
        was = self._breached.get(name, False)
        is_breach = not res["ok"]
        self._breached[name] = is_breach
        if is_breach and not was:
            log.warn("slo breach", objective=name, kind=res["kind"])
            self.registry.incr_counter("slo_breach_total", objective=name)
            self._annotate("slo.breach", name, res)
        elif was and not is_breach:
            log.info("slo recovered", objective=name, kind=res["kind"])
            self._annotate("slo.recover", name, res)

    @staticmethod
    def _annotate(event: str, name: str, res: dict) -> None:
        """Zero-duration flight-recorder span so /debug/flight shows
        the transition in request context. Best-effort: SLO judgment
        must never break on tracing."""
        try:
            from celestia_tpu_torch import tracing

            t = time.perf_counter()
            tracing.emit(event, t, t, objective=name, kind=res["kind"])
        except Exception:  # noqa: BLE001
            pass


def engine_for(node) -> SloEngine:
    """The node's lazily-built singleton engine (rpc.py routes share
    one so breach-transition state is consistent across requests)."""
    eng = getattr(node, "slo", None)
    if eng is None:
        eng = node.slo = SloEngine()
    return eng


# ---------------------------------------------------------------------- #
# readiness: serving-fit, distinct from SLO health. /readyz answers
# "should a load balancer send this node DAS traffic NOW" — conditions
# are structural (backend, calibration, arena, data), not statistical.


def readiness(node) -> tuple[bool, list[dict]]:
    """Serving-fit checks for /readyz (specs/slo.md endpoint contract).

    Every check reports independently so a 503 body names exactly what
    is unfit; the node is ready iff all pass."""
    app = node.app
    checks: list[dict] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        entry = {"name": name, "ok": bool(ok)}
        if detail:
            entry["detail"] = detail
        checks.append(entry)

    # sticky degradation first: it also forces backend re-resolution
    check("not_sticky_degraded", not app._gpu_disabled,
          "" if not app._gpu_disabled else
          f"gpu sticky-disabled after {app._gpu_strikes} strikes")

    # corruption quarantine (ADR-015): the node still serves (host
    # recompute restored every result), but a load balancer should
    # prefer replicas whose hardware has not produced a wrong answer
    quarantined = bool(getattr(app, "sdc_quarantined", False))
    last = getattr(app, "last_sdc", None) or {}
    check("not_sdc_quarantined", not quarantined,
          "" if not quarantined else
          f"sdc at {last.get('site', 'unknown')} "
          f"(height {last.get('height', '?')})")

    try:
        live = app.resolve_extend_backend(app.gov_square_size_upper_bound())
        check("backend_resolved", True, f"live={live}")
    except Exception as e:  # noqa: BLE001 — unresolvable backend = unfit
        check("backend_resolved", False, str(e))

    table = app.crossover
    if table is None:
        # no table is a legitimate configuration (static-threshold
        # fallback, ADR-012) — only a STALE table is unfit, because
        # 'auto' would then route on measurements of dead hardware
        check("crossover_fresh", True, "no table (static fallback)")
    else:
        age = time.time() - table.measured_at if table.measured_at else 0.0
        check("crossover_fresh", age <= CROSSOVER_MAX_AGE_S,
              f"age_s={age:.0f}")

    pool = app.blob_pool
    if pool is None:
        check("arena_not_exhausted", True, "no arena attached")
    else:
        # the arena is healthy while puts still land device-resident;
        # sustained fallback means proposals pay host staging again
        assembled = app.arena_stats.get("assembled", 0)
        fallback = app.arena_stats.get("fallback", 0)
        exhausted = fallback > 0 and fallback > 4 * max(1, assembled)
        check("arena_not_exhausted", not exhausted,
              f"assembled={assembled} fallback={fallback}")

    # overload (ADR-016): a node whose admission queue is full RIGHT
    # NOW would shed the next request — tell the load balancer to
    # route around it until the queue recedes. A draining dispatcher
    # (graceful shutdown in progress) is likewise unfit by design.
    dispatcher = getattr(node, "dispatcher", None)
    if dispatcher is None:
        check("not_overloaded", True, "no dispatcher attached")
    else:
        saturated = dispatcher.saturated()
        draining = dispatcher.draining
        check("not_overloaded", not (saturated or draining),
              f"queue={dispatcher.depth}/{dispatcher.capacity}"
              + (" draining" if draining else ""))

    # durable-store writability (ADR-026): a read-only store still
    # SERVES — but a load balancer placing fresh traffic should prefer
    # replicas whose durable history is still growing, and the fleet
    # supervisor reads this exact check name to classify the member
    # storage-degraded instead of unhealthy (node/fleet.py)
    store = getattr(node, "store", None)
    if store is None:
        check("store_writable", True, "no store attached")
    else:
        ro = bool(getattr(store, "read_only", False))
        check("store_writable", not ro,
              "" if not ro else
              f"store read-only ({getattr(store, 'read_only_reason', '?')})")

    # a DA node with no data cannot answer a single /sample — not ready
    # until the first block lands (this is the 503→200 startup flip the
    # obs-smoke gate pins)
    height = node.latest_height()
    check("has_blocks", height >= 1, f"height={height}")

    return all(c["ok"] for c in checks), checks
