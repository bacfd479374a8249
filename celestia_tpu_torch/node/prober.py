"""Synthetic DAS prober: black-box sampling of the node's own serve path
(port of the JAX package's node/prober.py).

The SLO engine's availability objective (celestia_tpu_torch/slo.py) needs a
signal that is TRUE end-to-end — a node can have healthy counters while
its share-serving path returns garbage. This prober is that signal: a
background thread that periodically plays light client against the
node's real HTTP surface — ``/status`` → ``/dah/<h>`` → random
``/sample/<h>/<i>/<j>`` cells — and VERIFIES every returned NMT proof
against the DAH row roots, exactly as node/client.py's
``sample_availability`` does. Optionally it also exercises the
``/proof/share`` route and checks the returned range proof against the
DAH. Nothing is trusted on shape alone: a sample only counts as ok when
the proof recomputes the authenticated root.

Every probe outcome lands in telemetry:

    probe_sample_total / probe_sample_ok_total        per-cell counters
    probe_share_proof_total / probe_share_proof_ok_total
    probe_cycle_total / probe_cycle_ok_total          per-cycle counters
    probe_sample (histogram, seconds)                 per-cell latency
    probe_availability_ratio (gauge)                  running ok/total

The fetches pass through the ``probe.request`` fault site, so a chaos
test arms ``faults.inject(rule("probe.request", "error"), seed=N)`` and
deterministically drives the availability objective into breach
(tests/test_torch_prober_slo.py) — the acceptance path for "the SLO engine reads
black-box truth, including under fault injection".

The prober is OFF by default (``cli start --probe-interval`` turns it
on): with no thread running the serve path pays nothing. Every check runs
on the host: the proofs and the crosscheck's erasure-code relation.

The thread's cadence is an absolute grid: ``clock`` (``time.monotonic`` by
default) places the slots and ``wait`` (the stop event's ``wait`` by
default) sleeps to the next, so a test steps the cadence without a wall
clock.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.request

from celestia_tpu_torch import faults, tracing
from celestia_tpu_torch.log import logger

log = logger("prober")


class Prober:
    """Background DAS self-probe against one node RPC base URL."""

    def __init__(self, base_url: str, interval: float = 5.0,
                 samples_per_cycle: int = 4, timeout: float = 5.0,
                 share_proofs: bool = True, rng: random.Random | None = None,
                 registry=None, host_crosscheck: bool = False,
                 clock=time.monotonic, wait=None):
        if registry is None:
            from celestia_tpu_torch.telemetry import metrics as registry
        self.base_url = base_url.rstrip("/")
        self.interval = interval
        self.samples_per_cycle = samples_per_cycle
        self.timeout = timeout
        self.share_proofs = share_proofs
        # opt-in SDC cross-check (ADR-015): one sampled row per cycle
        # is re-verified against the erasure code on the host
        self.host_crosscheck = host_crosscheck
        # seedable for deterministic tests; SystemRandom in production
        # so a probing pattern cannot be predicted/special-cased
        self.rng = rng if rng is not None else random.SystemRandom()
        self.metrics = registry
        self.last: dict = {}  # newest cycle summary (served in /debug/slo)
        self._stop = threading.Event()
        self._clock = clock
        self._wait = wait if wait is not None else self._stop.wait
        self._thread: threading.Thread | None = None
        self._ctx = None  # current cycle's TraceContext (tracing on)

    # -- transport ----------------------------------------------------- #

    def _get(self, path: str):
        """One GET through the probe.request fault site. Raises on any
        transport/HTTP/parse failure — the caller counts it. Carries
        the cycle's ``X-Trace-Context`` when tracing is on, so every
        fetch of one probe cycle lands in ONE fleet trace."""
        url = self.base_url + path
        faults.fire("probe.request", url=url)
        req = urllib.request.Request(url)
        if self._ctx is not None:
            req.add_header(tracing.TRACE_HEADER, self._ctx.header_value())
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    # -- one probe cycle ----------------------------------------------- #

    def probe_cycle(self) -> dict:
        """Synchronously run one cycle (the thread body and tests share
        it). Returns the cycle summary; never raises."""
        summary = {"ok": False, "samples": 0, "sample_ok": 0,
                   "share_proofs": 0, "share_proof_ok": 0, "error": None}
        self._ctx = tracing.mint() if tracing.enabled() else None
        if self._ctx is not None:
            summary["trace_id"] = self._ctx.trace_id
        try:
            status = self._get("/status")
            height = int(status.get("height", 0))
        except Exception as e:  # noqa: BLE001 — unreachable node: cycle fails
            summary["error"] = f"status: {e}"
            self._finish(summary)
            return summary
        if height < 1:
            # nothing to sample yet — not a failure, not a data point
            summary["error"] = "no blocks yet"
            self.last = summary
            return summary
        try:
            dah = self._fetch_dah(height)
        except Exception as e:  # noqa: BLE001
            summary["error"] = f"dah: {e}"
            self._finish(summary)
            return summary
        w = len(dah.row_roots)
        k = w // 2
        for _ in range(self.samples_per_cycle):
            i, j = self.rng.randrange(w), self.rng.randrange(w)
            summary["samples"] += 1
            if self._probe_sample(height, i, j, dah, k, w):
                summary["sample_ok"] += 1
        if self.share_proofs:
            summary["share_proofs"] = 1
            if self._probe_share_proof(height, self.rng.randrange(k * k),
                                       dah):
                summary["share_proof_ok"] += 1
        crosscheck_ok = True
        if self.host_crosscheck:
            summary["crosschecks"] = 1
            crosscheck_ok = self._probe_host_crosscheck(
                height, self.rng.randrange(w), k, w
            )
            summary["crosscheck_ok"] = int(crosscheck_ok)
        summary["ok"] = (
            summary["sample_ok"] == summary["samples"]
            and summary["share_proof_ok"] == summary["share_proofs"]
            and crosscheck_ok
        )
        summary["height"] = height
        self._finish(summary)
        return summary

    def _fetch_dah(self, height: int):
        from celestia_tpu_torch.da import DataAvailabilityHeader

        doc = self._get(f"/dah/{height}")
        dah = DataAvailabilityHeader.from_json(doc)
        if len(dah.row_roots) < 2:
            raise ValueError("DAH has no rows")
        return dah

    def _probe_sample(self, height: int, i: int, j: int, dah, k: int,
                      w: int) -> bool:
        """Fetch + cryptographically verify one extended-square cell
        (the node/client.py sample_availability verification, inlined
        so the prober stays dependency-light)."""
        from celestia_tpu_torch.da import erasured_leaf_namespace
        from celestia_tpu_torch.proof import NmtRangeProof

        start = time.perf_counter()
        ok = False
        try:
            res = self._get(f"/sample/{height}/{i}/{j}")
            share = bytes.fromhex(res["share"])
            p = res["proof"]
            proof = NmtRangeProof(
                start=int(p["start"]), end=int(p["end"]),
                nodes=[bytes.fromhex(x) for x in p["nodes"]],
                tree_size=int(p["tree_size"]),
            )
            if (proof.start, proof.end) != (j, j + 1) or \
                    proof.tree_size != w:
                raise ValueError("proof shape mismatch")
            ns = erasured_leaf_namespace(i, j, share, k)
            proof.verify_inclusion(dah.row_roots[i], [ns], [share])
            ok = True
        except Exception as e:  # noqa: BLE001 — ANY failure = unavailable
            log.debug("probe sample failed", height=height, row=i, col=j,
                      error=str(e))
        self.metrics.measure_since("probe_sample", start)
        self.metrics.incr_counter("probe_sample_total")
        if ok:
            self.metrics.incr_counter("probe_sample_ok_total")
        return ok

    def _probe_share_proof(self, height: int, idx: int, dah) -> bool:
        """Exercise /proof/share for one ODS share and verify the
        returned NMT range proof against the DAH row root it claims."""
        from celestia_tpu_torch.proof import NmtRangeProof

        ok = False
        try:
            res = self._get(f"/proof/share/{height}:{idx}:{idx + 1}")
            ns = bytes.fromhex(res["namespace"])
            data = [bytes.fromhex(s) for s in res["data"]]
            sp = res["share_proofs"][0]
            row = int(res["row_proof"]["start_row"])
            served_root = bytes.fromhex(res["row_proof"]["row_roots"][0])
            # the proof must chain to a root WE authenticated (the
            # DAH), not merely to one the reply carries
            if served_root != dah.row_roots[row]:
                raise ValueError("row root not in the DAH")
            proof = NmtRangeProof(
                start=int(sp["start"]), end=int(sp["end"]),
                nodes=[bytes.fromhex(x) for x in sp["nodes"]],
                tree_size=len(dah.row_roots),
            )
            proof.verify_inclusion(
                dah.row_roots[row], [ns] * len(data), data
            )
            ok = True
        except Exception as e:  # noqa: BLE001
            log.debug("probe share proof failed", height=height, idx=idx,
                      error=str(e))
        self.metrics.incr_counter("probe_share_proof_total")
        if ok:
            self.metrics.incr_counter("probe_share_proof_ok_total")
        return ok

    def _probe_host_crosscheck(self, height: int, i: int, k: int,
                               w: int) -> bool:
        """Opt-in SDC cross-check (host_crosscheck=True, ADR-015):
        fetch every cell of ONE sampled row and re-verify the erasure
        relation host-side. NMT proofs only bind shares to the
        COMMITTED roots — if the square was committed mis-encoded
        (silent corruption upstream of the DAH), every per-cell proof
        still verifies; the code relation is the one invariant that
        cannot. A failure here is recorded as a detected SDC."""
        import numpy as np

        from celestia_tpu_torch.da import fraud

        ok = False
        try:
            cells = []
            for j in range(w):
                res = self._get(f"/sample/{height}/{i}/{j}")
                cells.append(
                    np.frombuffer(bytes.fromhex(res["share"]), dtype=np.uint8)
                )
            ok = not fraud._axis_is_bad(np.stack(cells), k)
        except Exception as e:  # noqa: BLE001 — unverifiable = not ok
            log.debug("probe crosscheck failed", height=height, row=i,
                      error=str(e))
        self.metrics.incr_counter("probe_crosscheck_total")
        if ok:
            self.metrics.incr_counter("probe_crosscheck_ok_total")
        else:
            try:
                from celestia_tpu_torch import integrity

                integrity.record_sdc("probe.crosscheck")
            except Exception:  # noqa: BLE001 — accounting never kills probes
                pass
            log.warn("probe crosscheck: row violates the erasure code",
                     height=height, row=i)
        return ok

    def _finish(self, summary: dict) -> None:
        self.last = summary
        self.metrics.incr_counter("probe_cycle_total")
        if summary["ok"]:
            self.metrics.incr_counter("probe_cycle_ok_total")
        elif self._ctx is not None:
            # zero-duration annotation: a failed cycle drops a pin in
            # the trace timeline carrying ITS trace id, so "which
            # request chain did the prober see break" is one flight/
            # trace lookup instead of a log-to-metrics join
            now = time.perf_counter()
            tracing.emit("probe.fail", now, end=now,
                         trace_id=self._ctx.trace_id,
                         error=str(summary.get("error") or "probe failed"),
                         samples=summary["samples"],
                         sample_ok=summary["sample_ok"])
        total = self.metrics.get_counter("probe_sample_total")
        good = self.metrics.get_counter("probe_sample_ok_total")
        if total:
            self.metrics.set_gauge("probe_availability_ratio", good / total)

    # -- thread lifecycle ---------------------------------------------- #

    def start(self) -> "Prober":
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="das-prober")
        self._thread.start()
        log.info("prober started", base_url=self.base_url,
                 interval_s=self.interval,
                 samples=self.samples_per_cycle)
        return self

    def _run(self) -> None:
        # cycles fire on an ABSOLUTE clock grid. The old loop slept a
        # fixed interval AFTER each cycle, so a slow serve path
        # silently lowered the probe rate — the prober coordinated
        # with the very degradation it exists to measure. Now a slow
        # cycle overruns its slot (counted), the missed grid points
        # are skipped, and the cadence stays honest.
        next_slot = self._clock()
        while not self._stop.is_set():
            try:
                self.probe_cycle()
            except Exception as e:  # noqa: BLE001 — the loop never dies
                log.error("probe cycle crashed", error=str(e))
            next_slot = self._next_slot(next_slot)
            self._wait(max(0.0, next_slot - self._clock()))

    def _next_slot(self, slot: float) -> float:
        """The grid point after ``slot`` that is still ahead of the clock:
        a cycle that overran its slot is counted, and the grid points it
        missed are skipped."""
        slot += self.interval
        now = self._clock()
        if now >= slot:
            self.metrics.incr_counter("probe_overrun_total")
            while slot <= now:
                slot += self.interval
        return slot

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 1.0)
            self._thread = None
