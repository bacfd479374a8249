"""Scenario world: the crypto-free node-under-test plus load drivers (port
of the JAX package's scenarios/world.py).

The world composes the instruments the earlier PRs built — the real
node/rpc.py serving stack (device dispatcher, bounded admission,
deadlines, drain) over the chaosnet DA facade, the synthetic DAS
prober, and the integrity-audited device extend path — into one
process the scenario engine can storm. Everything here runs without
the signing stack, so every `make scenario-*` target works in a
stripped environment; the load SHAPES still come from txsim's
TrafficProfiles, so the traffic mix matches what the signed path would
produce.

Production modes:

    plain   ``grow()`` appends host-extended squares (chaosnet).
    sdc     each block is produced THROUGH the audited device path on
            the world's ``device`` (None means CUDA): H2D staging via
            ``transfers.device_put_chunked`` (checksum per chunk) then
            ``extend.extend_roots_device`` under
            ``integrity.configure("full")`` (the fused route: K1 three
            times, K2 and the tree kernel). A bitflip campaign at
            ``device.extend.output`` / ``transfer.chunk`` strikes MID
            PRODUCTION; a detection quarantines (mirroring
            App._quarantine_gpu: /readyz + /status flip), recomputes
            on host, and commits the byte-identical host DAH — the
            zero-undetected-SDC ledger the verdict audits. Only
            ``faults.DeviceUnavailable`` (a host-fallback block) and
            ``integrity.IntegrityError`` (a quarantine) are caught; any
            other exception propagates, as the App's degrade does.

The readiness watcher samples /readyz continuously and the world keeps
a ledger of expected degradation windows (GPU strikes, SDC
quarantines, overload campaigns); the readyz_well_ordered invariant
cross-checks one against the other.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from celestia_tpu_torch import da, faults, txsim
from celestia_tpu_torch import device as device_mod
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.testutil.chaosnet import RpcChaosNode, chain_array, extend_chain

from .openload import OpenLoadMeter
from .spec import LoadSpec, Scenario

log = logger("scenarios")


class _TxResult:
    __slots__ = ("code", "log", "priority")

    def __init__(self, code: int, log: str = "", priority: int = 0):
        self.code, self.log, self.priority = code, log, priority


class ScenarioNode(RpcChaosNode):
    """RpcChaosNode + a bounded mempool so PFB storms exercise real
    admission behavior (a saturated mempool rejects, it doesn't grow
    unboundedly) and block production drains what the storm staged."""

    def __init__(self, *, mempool_cap: int = 512, **kw):
        super().__init__(**kw)
        self.mempool_cap = mempool_cap
        self.mempool_bytes = 0
        self._mempool_lock = threading.Lock()
        self.mempool_stats = {"accepted": 0, "rejected_full": 0,
                              "drained_txs": 0, "drained_bytes": 0}

    def broadcast_tx(self, raw: bytes) -> _TxResult:
        with self._mempool_lock:
            if len(self.mempool) >= self.mempool_cap:
                self.mempool_stats["rejected_full"] += 1
                return _TxResult(19, "mempool is full")
            self.mempool.append(raw)
            self.mempool_bytes += len(raw)
            self.mempool_stats["accepted"] += 1
        return _TxResult(0, "", priority=len(raw))

    def drain_mempool(self) -> tuple[int, int]:
        """Block production's reap: empties the pool, returns
        (txs, bytes) folded into the produced block's stats."""
        with self._mempool_lock:
            txs, size = len(self.mempool), self.mempool_bytes
            self.mempool.clear()
            self.mempool_bytes = 0
            self.mempool_stats["drained_txs"] += txs
            self.mempool_stats["drained_bytes"] += size
        return txs, size


def _fetch(base: str, path: str, timeout: float = 5.0):
    """(status, json_body) over urllib; HTTP errors return their code."""
    req = urllib.request.Request(base + path)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except ValueError:
            body = {}
        return e.code, body


def _verify_sample(dah, k: int, i: int, j: int, body: dict) -> bool:
    """Recompute the NMT inclusion proof against the DAH row root —
    the same acceptance rule the prober and light clients apply."""
    from celestia_tpu_torch.da import erasured_leaf_namespace
    from celestia_tpu_torch.proof import NmtRangeProof

    try:
        share = bytes.fromhex(body["share"])
        p = body["proof"]
        proof = NmtRangeProof(
            start=int(p["start"]), end=int(p["end"]),
            nodes=[bytes.fromhex(x) for x in p["nodes"]],
            tree_size=int(p["tree_size"]),
        )
        ns = erasured_leaf_namespace(i, j, share, k)
        proof.verify_inclusion(dah.row_roots[i], [ns], [share])
        return True
    except Exception:  # noqa: BLE001 — any verification failure counts
        return False


class ScenarioWorld:
    """One scenario's node-under-test, probe loop, and load drivers."""

    def __init__(self, scenario: Scenario, seed: int, registry=None,
                 device=None):
        if registry is None:
            from celestia_tpu_torch.telemetry import metrics as registry
        # None means CUDA: raises here on a host without a GPU unless the
        # caller asks for the CPU
        self.device = device_mod.resolve(device)
        self.scenario = scenario
        self.seed = seed
        self.registry = registry
        # soak store: fsync-relaxed (the atomic rename still guards
        # torn writes; the soak is throughput-bound, not crash-bound)
        self._store_tmp = None
        node_kw = {}
        if scenario.store:
            import tempfile

            self._store_tmp = tempfile.TemporaryDirectory(
                prefix=f"soak-{scenario.name}-")
            node_kw = {"store_dir": self._store_tmp.name,
                       "store_durable": False}
        self.node = ScenarioNode(
            heights=scenario.initial_heights, k=scenario.k, seed=seed,
            chain_id=f"scenario-{scenario.name}",
            mempool_cap=scenario.mempool_cap, **node_kw,
        )
        from celestia_tpu_torch.node.rpc import RpcServer

        self.server = RpcServer(
            self.node, port=0,
            queue_capacity=scenario.queue_capacity,
            default_deadline_s=scenario.default_deadline_s,
        )
        self.url = None  # set on start
        import random as _random

        from celestia_tpu_torch.node.prober import Prober

        self._prober_rng = _random.Random(seed)
        self.prober = None  # built on start (needs the port)
        self._prober_cls = Prober
        # follower (rejoin-under-load): a second node + server booted
        # by the follower_boot action, caught up by the sync driver
        self.follower: ScenarioNode | None = None
        self.follower_server = None
        self.follower_synced: list[int] = []
        self.follower_stats = {"installed": 0, "retries_absorbed": 0,
                               "verify_rejected": 0}
        # readiness watch + degradation ledger
        self.readyz_samples: list[tuple[float, bool, tuple[str, ...]]] = []
        self._watch_stop = threading.Event()
        self._watch_thread: threading.Thread | None = None
        self.degradations: list[dict] = []  # {kind, t0, t1|None}
        # SDC production ledger (sdc_producer mode)
        self.sdc_detections: list[dict] = []
        self.sdc_missed: list[dict] = []
        self.produced = {"blocks": 0, "device_blocks": 0,
                         "host_fallback_blocks": 0}
        self._produce_lock = threading.Lock()
        self._producer_stop = threading.Event()
        self._producer_thread: threading.Thread | None = None
        self.das_stats = {"ok": 0, "verify_fail": 0, "shed": 0,
                          "deadline": 0, "not_found": 0, "error": 0}
        self.pfb_stats = {"accepted": 0, "rejected": 0, "bytes": 0,
                          "http_error": 0}
        self._stats_lock = threading.Lock()
        # open-loop metering (scenarios/openload.py) + soak state; the
        # engine sets duration_scale before start and drift_report at
        # teardown (from the recorded .ctts, not live snapshots)
        self.openload = OpenLoadMeter()
        self.duration_scale = 1.0
        self.soak_anchors: list[dict] = []
        self.drift_report: dict | None = None
        self._soak_t0: float | None = None
        self._soak_budget_cap: int | None = None
        self._soak_lag_cap: int | None = None

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> None:
        self._soak_t0 = time.monotonic()
        if self.scenario.sdc_producer:
            from celestia_tpu_torch import integrity

            integrity.configure("full")
        self.server.start()
        self.url = f"http://127.0.0.1:{self.server.port}"
        self.prober = self._prober_cls(
            self.url, samples_per_cycle=4, timeout=5.0,
            share_proofs=False, rng=self._prober_rng,
            registry=self.registry,
        )
        self._watch_thread = threading.Thread(target=self._watch_readyz,
                                              daemon=True)
        self._watch_thread.start()
        if self.scenario.sdc_producer:
            # warm the device extend's builders before the timeline
            # starts — phase-scoped campaign rules are dormant here
            # (injector phase is None), so warmup hits consume nothing
            self.produce_block()
        self._producer_thread = threading.Thread(target=self._produce_loop,
                                                 daemon=True)
        self._producer_thread.start()

    def stop(self) -> None:
        self._producer_stop.set()
        if self._producer_thread is not None:
            self._producer_thread.join(timeout=10)
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5)
        self.server.stop(drain_timeout=5.0)
        if self.follower_server is not None:
            self.follower_server.stop(drain_timeout=2.0)
        if self.scenario.sdc_producer:
            from celestia_tpu_torch import integrity

            integrity.configure("off")
        if self._store_tmp is not None:
            self._store_tmp.cleanup()
            self._store_tmp = None

    def quiesce(self, timeout: float = 3.0) -> None:
        """Let in-flight serving settle before the teardown verdict."""
        deadline = time.monotonic() + timeout
        dispatcher = self.server.dispatcher
        while time.monotonic() < deadline and dispatcher.depth > 0:
            time.sleep(0.05)

    def freeze(self) -> None:
        """Halt block production for the teardown verdict: heights are
        stable from here, so every invariant probe judges a fixed chain
        instead of racing the block interval. Serving stays up."""
        self._producer_stop.set()
        if self._producer_thread is not None:
            self._producer_thread.join(timeout=10)

    # -- phase-boundary actions ---------------------------------------- #

    def apply_actions(self, actions: tuple[str, ...]) -> None:
        for name in actions:
            getattr(self, f"_action_{name}")()

    def _action_gpu_strike(self) -> None:
        """Rolling-outage strike: the stub app mirrors what three real
        strikes do (app.py _degrade_gpu) — sticky disable, visible on
        /readyz AND on the SLO board via the disable counter."""
        app = self.node.app
        app._gpu_strikes = app.GPU_STRIKE_LIMIT
        app._gpu_disabled = True
        app.extend_backend = "gpu"  # so resolve falls back, like prod
        self.registry.incr_counter("extend_gpu_disabled_total")
        self.note_degradation("gpu_strike")

    def _action_gpu_recover(self) -> None:
        app = self.node.app
        app._gpu_strikes = 0
        app._gpu_disabled = False
        app.extend_backend = "numpy"
        self.end_degradation("gpu_strike")

    def _action_sdc_clear(self) -> None:
        """Operator intervention after a quarantine: hardware swapped
        or revalidated, the replica returns to the serving set."""
        self.node.app.sdc_quarantined = False
        self.end_degradation("sdc")

    def _action_disk_pressure_on(self) -> None:
        """Open the declared storage-degradation window (ADR-026). The
        flipping itself is the campaign's job — enospc rules armed at
        `store.write` strike the next persisted put — this action only
        tells the readiness verdict the window during which a
        store_writable 503 is EXPLAINED rather than stray."""
        self.note_degradation("store")

    def _action_disk_pressure_off(self) -> None:
        """Operator freed disk space: recover the store (the probe
        write rides the real shim sites, so it stays read-only if the
        pressure is actually still on) and close the window."""
        store = getattr(self.node, "store", None)
        if store is not None and store.read_only:
            store.try_recover()
        self.end_degradation("store")

    def _action_follower_boot(self) -> None:
        from celestia_tpu_torch.node.rpc import RpcServer

        self.follower = ScenarioNode(
            heights=0, k=self.scenario.k, seed=self.seed,
            chain_id=self.node.chain_id,
            mempool_cap=self.scenario.mempool_cap,
        )
        self.follower_server = RpcServer(self.follower, port=0,
                                         queue_capacity=16)
        self.follower_server.start()

    def note_degradation(self, kind: str) -> None:
        self.degradations.append({"kind": kind,
                                  "t0": time.monotonic(), "t1": None})

    def end_degradation(self, kind: str) -> None:
        for d in reversed(self.degradations):
            if d["kind"] == kind and d["t1"] is None:
                d["t1"] = time.monotonic()
                return

    # -- readiness watch ----------------------------------------------- #

    def _watch_readyz(self) -> None:
        while not self._watch_stop.is_set():
            try:
                status, body = _fetch(self.url, "/readyz", timeout=3.0)
                failing = tuple(
                    c["name"] for c in body.get("checks", ())
                    if not c.get("ok", True)
                )
                self.readyz_samples.append(
                    (time.monotonic(), status == 200, failing))
            except Exception:  # noqa: BLE001 — server mid-stop
                pass
            self._watch_stop.wait(0.15)

    def readyz_transitions(self) -> list[tuple[float, bool, tuple[str, ...]]]:
        out = []
        last = None
        for t, ready, failing in self.readyz_samples:
            if ready != last:
                out.append((t, ready, failing))
                last = ready
        return out

    # -- block production ---------------------------------------------- #

    def _produce_loop(self) -> None:
        interval = self.scenario.block_interval_s
        while not self._producer_stop.is_set():
            try:
                self.produce_block()
            except Exception as e:  # noqa: BLE001 — keep the chain alive;
                # the verdict's DAH audit catches a broken height
                log.warn("block production failed", error=f"{type(e).__name__}: {e}")
            self._producer_stop.wait(interval)

    def produce_block(self) -> int:
        with self._produce_lock:
            h = self.node.latest_height() + 1
            self.node.drain_mempool()
            if not self.scenario.sdc_producer:
                self.node.grow()
                self.produced["blocks"] += 1
                self._soak_housekeeping(h)
                return h
            # lint: allow(C002,C003) reason=the scenario world serializes block production on purpose (one producer thread, chaos harness not serving stack); the same design is waived at the direct device_put_chunked site below
            return self._produce_block_device(h)

    # -- soak housekeeping (store churn + identity anchors) ------------- #

    @property
    def soak_lag(self) -> int:
        """The byte-identity re-verification distance, scaled with
        --duration-scale so shorter CI runs still cross it (floor 10:
        a lag of zero would make the invariant vacuous)."""
        lag = self.scenario.soak_sample_lag
        lag = max(10, round(lag * min(1.0, self.duration_scale)))
        # lint: allow(C005) reason=written once by the single producer thread (under _produce_lock) and only ever shrinks the lag; a one-read-stale None just means one more anchor at the configured lag
        if self._soak_lag_cap is not None:
            # compaction froze a retention window smaller than the
            # configured lag — an anchor must age within what the store
            # actually retains, or every anchor is evicted unverified
            lag = max(10, min(lag, self._soak_lag_cap))
        return lag

    def _soak_housekeeping(self, h: int) -> None:
        """Per-produced-block soak chores (store mode only): prune the
        in-memory block map to the retention window (long chains must
        not hold RSS hostage — serving older heights falls through to
        CRC-verified store page reads), compact the store against its
        byte budget every N blocks, and anchor a served sample every
        ~lag/8 heights for the soak_byte_identity re-verification."""
        sc = self.scenario
        if not sc.store or self.node.store is None:
            return
        if sc.retain_heights:
            cutoff = h - sc.retain_heights
            for old in [x for x in self.node.blocks if x <= cutoff]:
                self.node.blocks.pop(old, None)
                if self.node._eds_cache is not None:
                    try:
                        self.node._eds_cache.invalidate(old)
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
        if sc.store_compact_budget_bytes and \
                h % max(1, sc.store_compact_every) == 0:
            # Scale the byte budget with --duration-scale: a shortened
            # CI run writes proportionally fewer bytes, and an unscaled
            # budget would never fill — compaction would never fire and
            # store_bytes would read as monotone drift.
            budget = max(2 << 20,
                         round(sc.store_compact_budget_bytes
                               * min(1.0, self.duration_scale)))
            # The fill rate itself is NOT scale-free (jit warmup eats a
            # fixed slice of short runs), so even a scaled budget may be
            # out of reach before the drift probe's 25% warmup window
            # closes. Once ~20% of the planned wall has elapsed, freeze
            # whatever the store filled to as a cap: compaction holds
            # that level for the rest of the run — a steady state the
            # run is guaranteed to reach, at any --duration-scale.
            if self._soak_budget_cap is None and self._soak_t0 is not None:
                planned = sum(p.duration_s for p in sc.phases) \
                    * min(1.0, self.duration_scale)
                if time.monotonic() - self._soak_t0 >= 0.2 * planned:
                    stats = self.node.store.stats()
                    self._soak_budget_cap = max(2 << 20,
                                                int(stats["bytes"]))
                    # the frozen byte level also bounds retention in
                    # heights: shrink the identity-anchor lag to age
                    # inside it (half, for compaction-cadence margin)
                    self._soak_lag_cap = max(10,
                                             int(stats["heights"]) // 2)
            if self._soak_budget_cap is not None:
                budget = min(budget, self._soak_budget_cap)
            self.node.store.compact(budget)
        if sc.soak_sample_lag and self.url is not None:
            every = max(5, self.soak_lag // 8)
            if h % every == 0:
                self._anchor_sample(h)

    def _anchor_sample(self, h: int) -> None:
        """Record one served sample body at height h; the
        soak_byte_identity probe re-fetches it once the chain is
        soak_lag heights past h and demands byte equality + a fresh
        NMT verification."""
        w = 2 * self.scenario.k
        i, j = (h * 3) % w, (h * 7) % w
        try:
            status, body = _fetch(self.url, f"/sample/{h}/{i}/{j}",
                                  timeout=3.0)
        except Exception:  # noqa: BLE001 — anchor under load: retry later
            return
        if status != 200:
            return
        dah = self.node.block_dah(h)
        self.soak_anchors.append({
            "height": h, "i": i, "j": j, "body": body,
            "dah_hash": dah.hash().hex() if dah is not None else None,
        })

    def _produce_block_device(self, h: int) -> int:
        """The audited device production path (ADR-015 flow): host
        reference first, then the device attempt under full audits; a
        detection quarantines + commits the host result byte-identically."""
        from celestia_tpu_torch import integrity
        from celestia_tpu_torch.ops import extend, transfers

        host_eds, host_dah = extend_chain(self.scenario.k, h, self.seed)
        grid = chain_array(self.scenario.k, h, self.seed)
        try:
            # H2D staging rides the checksummed chunked transfer (the
            # transfer.chunk SDC site); a single flip heals via the one
            # checksum retry, a sticky flip raises
            # lint: allow(C002) reason=_produce_lock exists to serialize whole-block production in the test world, device work included; no serving path ever waits on it
            transfers.device_put_chunked(grid.reshape(-1), self.device,
                                         site="scenario.stage", chunks=2)
            _eds, rows, cols = extend.extend_roots_device(grid, self.device)
            dev_dah = da.DataAvailabilityHeader(
                [bytes(r) for r in rows], [bytes(c) for c in cols])
            if dev_dah.hash() != host_dah.hash():
                # an audit MISS that diverged the DAH: record it as the
                # undetected flip it is (the zero_undetected_sdc probe
                # fails the run on this ledger) and fall back to host
                self.sdc_missed.append({"height": h})
                self.produced["host_fallback_blocks"] += 1
            else:
                self.produced["device_blocks"] += 1
        except integrity.IntegrityError as e:
            self._quarantine(h, getattr(e, "site", "unknown"), host_dah)
        except faults.DeviceUnavailable:  # the device path is down
            self.produced["host_fallback_blocks"] += 1
        # commit the host-extended square either way: byte-identical
        # DAH across degradations is the invariant under audit
        self.node.blocks[h] = (host_eds, host_dah)
        self.produced["blocks"] += 1
        return h

    def _quarantine(self, h: int, site: str, host_dah) -> None:
        """Mirror App._quarantine_gpu's observable surface on the stub
        app: sticky quarantine + /status evidence + host recompute."""
        app = self.node.app
        first = not app.sdc_quarantined
        app.sdc_quarantined = True
        app.sdc_events += 1
        app.last_sdc = {"site": site, "height": h}
        _eds, recomputed = extend_chain(self.scenario.k, h, self.seed)
        self.sdc_detections.append({
            "height": h, "site": site, "quarantined": True,
            "host_dah": recomputed.hash().hex(),
            "reference_dah": host_dah.hash().hex(),
        })
        self.produced["host_fallback_blocks"] += 1
        if first:
            self.note_degradation("sdc")

    # -- load drivers -------------------------------------------------- #

    def start_loads(self, loads: tuple[LoadSpec, ...], phase_seed: int,
                    stop: threading.Event) -> list[threading.Thread]:
        threads = []
        for li, spec in enumerate(loads):
            for ci in range(spec.clients):
                target = {
                    "das": self._das_client,
                    "pfb": self._pfb_client,
                    "follower_sync": self._follower_sync,
                    "open_das": self._open_das_client,
                }[spec.kind]
                t = threading.Thread(
                    target=target,
                    args=(spec, phase_seed * 1_000 + li * 100 + ci, stop),
                    daemon=True,
                )
                t.start()
                threads.append(t)
        return threads

    def _pace(self, spec: LoadSpec, stop: threading.Event) -> None:
        if spec.rate_hz:
            stop.wait(1.0 / spec.rate_hz)

    def _das_client(self, spec: LoadSpec, seed: int,
                    stop: threading.Event) -> None:
        """One light client: fetch the DAH, sample random cells,
        verify every proof — the flash-crowd unit."""
        rng = np.random.default_rng(seed)
        w = 2 * self.scenario.k
        while not stop.is_set():
            try:
                h = int(rng.integers(1, max(2, self.node.latest_height() + 1)))
                i, j = int(rng.integers(0, w)), int(rng.integers(0, w))
                status, body = _fetch(self.url, f"/sample/{h}/{i}/{j}")
                key = {200: "ok", 503: "shed", 504: "deadline",
                       404: "not_found"}.get(status, "error")
                if status == 200:
                    dah = self.node.block_dah(h)
                    if dah is None:
                        # evicted between the sample fetch and the DAH
                        # lookup (store compaction) — a pruning race,
                        # not a failed proof
                        key = "not_found"
                    elif not _verify_sample(
                            dah, self.scenario.k, i, j, body):
                        key = "verify_fail"
                with self._stats_lock:
                    self.das_stats[key] += 1
            except Exception:  # noqa: BLE001 — transport-level failure
                with self._stats_lock:
                    self.das_stats["error"] += 1
            self._pace(spec, stop)

    def _open_das_client(self, spec: LoadSpec, seed: int,
                         stop: threading.Event) -> None:
        """One open-loop arrival process: Poisson inter-arrivals at
        spec.rate_hz scheduled on an ABSOLUTE clock, Zipf height
        popularity (newest = most popular, skew from the traffic
        profile), latency measured from the INTENDED send time. A slow
        server makes this serial client fall behind its schedule; it
        then issues the overdue arrivals back-to-back and each one's
        latency carries the backlog — queue buildup is charged to the
        server, never silently absorbed (no coordinated omission)."""
        rng = np.random.default_rng(seed)
        prof = txsim.profile(spec.profile or "mixed-namespaces")
        w = 2 * self.scenario.k
        rate = float(spec.rate_hz)
        next_t = time.monotonic() + float(rng.exponential(1.0 / rate))
        pending: collections.deque[float] = collections.deque()
        while not stop.is_set():
            now = time.monotonic()
            # arrivals are OFFERED the moment their schedule point
            # passes — not when the serial client gets around to
            # issuing them. A saturated server therefore sees offered
            # keep tracking the schedule while done falls behind; the
            # goodput ratio exposes the collapse instead of the meter
            # quietly throttling offered down to the service rate.
            while next_t <= now:
                pending.append(next_t)
                next_t += float(rng.exponential(1.0 / rate))
                self.openload.note_offered()
                self.registry.incr_counter("openload_offered_total")
            if not pending:
                if stop.wait(min(next_t - now, 0.05)):
                    break
                continue
            intended = pending.popleft()
            head = max(1, self.node.latest_height())
            # Zipf(ns_skew) rank over heights, newest first, wrapped
            # into the served range — the mixed-namespaces popularity
            # shape applied to the height axis. Under a retention
            # policy the client follows the advertised window: asking
            # for heights the node has documented as pruned would
            # record honest 404s as goodput loss and fake a knee.
            window = head
            if self.scenario.retain_heights:
                window = min(window, self.scenario.retain_heights)
            rank = int(rng.zipf(max(1.01, prof.ns_skew)))
            h = head - ((rank - 1) % window)
            i, j = int(rng.integers(0, w)), int(rng.integers(0, w))
            ok = False
            try:
                status, _body = _fetch(self.url, f"/sample/{h}/{i}/{j}")
                ok = status == 200
            except Exception:  # noqa: BLE001 — transport failure = miss
                pass
            latency = time.monotonic() - intended
            self.registry.incr_counter(
                "openload_ok_total" if ok else "openload_miss_total")
            self.registry.observe("openload_latency", latency)
            self.openload.note(latency, ok)

    def _pfb_client(self, spec: LoadSpec, seed: int,
                    stop: threading.Event) -> None:
        """One broadcaster POSTing TrafficProfile-shaped PFB payloads
        at the real /broadcast_tx route."""
        rng = np.random.default_rng(seed)
        prof = txsim.profile(spec.profile)
        while not stop.is_set():
            try:
                blobs = prof.sample_pfb(rng)
                payload = b"".join(
                    sub_id + rng.integers(0, 256, size=size,
                                          dtype=np.uint8).tobytes()
                    for sub_id, size in blobs
                )
                req = urllib.request.Request(
                    self.url + "/broadcast_tx",
                    data=json.dumps({"tx": payload.hex()}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    body = json.loads(resp.read())
                with self._stats_lock:
                    if body.get("code") == 0:
                        self.pfb_stats["accepted"] += 1
                        self.pfb_stats["bytes"] += len(payload)
                    else:
                        self.pfb_stats["rejected"] += 1
            except Exception:  # noqa: BLE001 — 4xx/5xx/timeouts
                with self._stats_lock:
                    self.pfb_stats["http_error"] += 1
            self._pace(spec, stop)

    def _follower_sync(self, spec: LoadSpec, seed: int,
                       stop: threading.Event) -> None:
        """State-sync rejoin under load: the follower pulls each
        missing height's ORIGINAL quadrant over a real RpcClient
        (rpc.get fault site + retry/breaker), re-extends locally, and
        only installs a height whose recomputed DAH matches the
        primary's — a corrupted response can delay the sync but never
        poison the follower's store."""
        from celestia_tpu_torch.node.client import RpcClient, TransportError

        client = RpcClient(self.url, timeout=5.0)
        while not stop.is_set() and self.follower is not None:
            try:
                if not self._follower_sync_step(client):
                    stop.wait(0.05)
            except TransportError:
                self.follower_stats["retries_absorbed"] += 1
                stop.wait(0.05)
            except Exception:  # noqa: BLE001 — height raced away, etc.
                stop.wait(0.05)

    def _follower_sync_step(self, client) -> bool:
        """Fetch + verify + install the follower's next missing height.
        Returns False when already caught up, True on progress or on a
        rejected (corrupted) fetch that will be retried."""
        target = self.node.latest_height()
        have = self.follower.latest_height()
        if have >= target:
            return False
        h = have + 1
        doc = client.eds(h)
        dah_doc = client.dah(h)
        rows = [bytes.fromhex(r) for r in doc["rows"]]
        w = int(doc["width"])
        k = w // 2
        quadrant = [
            rows[i][j * da.SHARE_SIZE:(j + 1) * da.SHARE_SIZE]
            for i in range(k) for j in range(k)
        ]
        eds = da.extend_shares(quadrant, self.device)
        dah = da.new_data_availability_header(eds)
        if dah.to_json() != dah_doc:
            # tampered/corrupted fetch: reject, retry the height
            self.follower_stats["verify_rejected"] += 1
            return True
        self.follower.blocks[h] = (eds, dah)
        self.follower_synced.append(h)
        self.follower_stats["installed"] += 1
        return True

    def settle_follower(self, timeout: float = 10.0) -> None:
        """Teardown convergence pass: with production FROZEN, drain the
        follower's remaining lag synchronously so the convergence
        verdict is deterministic rather than a race against the block
        interval. No-op without a follower; transport errors retry
        until the timeout (campaign rules are dormant at teardown, so
        this only absorbs real stragglers)."""
        if self.follower is None:
            return
        from celestia_tpu_torch.node.client import RpcClient, TransportError

        client = RpcClient(self.url, timeout=5.0)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if not self._follower_sync_step(client):
                    return
            except TransportError:
                self.follower_stats["retries_absorbed"] += 1
                time.sleep(0.05)
            except Exception:  # noqa: BLE001
                time.sleep(0.05)
