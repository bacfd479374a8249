"""Fleet world: N store-backed backends behind the consistent-hash
gateway (ADR-021; port of the JAX package's scenarios/fleet.py).

``Scenario.fleet = N`` swaps ScenarioWorld for this subclass: the
primary node plus N-1 extra backends, each extra backend persisting
every produced block into its own on-disk BlockStore, all fronted by
``node/gateway.Gateway``. Every load driver and the prober point at
the GATEWAY url, so the flash crowd exercises (height, row) ring
placement, hedged failover, and the aggregated /status//readyz — not
a single node.

Block production is LOCKSTEP: one ``produce_block`` grows the primary
and every live backend under the same ``_produce_lock``, and because
every ScenarioNode shares (k, seed, chain_id) the replicas' squares
and DAHs are byte-identical by construction — which is exactly what
makes the ``backend_restart`` action auditable:

    backend_restart     rotate over the extra backends; for the
                        victim: record its persisted heights + DAH
                        hashes, pull it off the ring, stop its server,
                        boot a FRESH node (heights=0) over the SAME
                        store directory — recovery is the store
                        re-index, nothing else — and re-add it.

The ``restarted_serves_from_store`` invariant then demands each
restarted backend serve NMT-verified samples for its pre-restart
heights with byte-identical DAHs, with its store's page-read counter
proving the bytes came off disk (specs/store.md).

The primary deliberately has NO store: it anchors the chain in memory
so the verdict's host-recompute probes keep their existing oracle,
while the restartable backends prove the disk tier.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading

from .spec import Scenario
from .world import ScenarioNode, ScenarioWorld


class FleetWorld(ScenarioWorld):
    """ScenarioWorld + (fleet-1) store-backed backends + the gateway."""

    def __init__(self, scenario: Scenario, seed: int, registry=None,
                 device=None):
        super().__init__(scenario, seed, registry=registry, device=device)
        from celestia_tpu_torch.node.rpc import RpcServer

        self._store_root = tempfile.mkdtemp(prefix="fleet-")
        #: extra backends beyond the primary: {node, server, url, store_dir}
        self.backends: list[dict] = []
        for b in range(1, scenario.fleet):
            store_dir = os.path.join(self._store_root, f"backend{b}")
            node = ScenarioNode(
                heights=scenario.initial_heights, k=scenario.k, seed=seed,
                chain_id=self.node.chain_id,
                mempool_cap=scenario.mempool_cap,
                store_dir=store_dir,
            )
            server = RpcServer(
                node, port=0,
                queue_capacity=scenario.queue_capacity,
                default_deadline_s=scenario.default_deadline_s,
            )
            self.backends.append({"node": node, "server": server,
                                  "url": None, "store_dir": store_dir})
        self.gateway = None  # built on start
        self.primary_url: str | None = None
        #: backend_restart ledger the verdict audits
        self.restarts: list[dict] = []
        self._restart_rr = 0

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> None:
        from celestia_tpu_torch.node.gateway import Gateway

        self.server.start()
        self.primary_url = f"http://127.0.0.1:{self.server.port}"
        urls = [self.primary_url]
        for b in self.backends:
            b["server"].start()
            b["url"] = f"http://127.0.0.1:{b['server'].port}"
            urls.append(b["url"])
        self.gateway = Gateway(urls)
        self.gateway.start()
        # every load driver and the prober storm the GATEWAY, so the
        # fleet's placement/failover surface is what gets judged
        self.url = self.gateway.url
        self.prober = self._prober_cls(
            self.url, samples_per_cycle=4, timeout=5.0,
            share_proofs=False, rng=self._prober_rng,
            registry=self.registry,
        )
        self._watch_thread = threading.Thread(target=self._watch_readyz,
                                              daemon=True)
        self._watch_thread.start()
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
        # gateway first so nothing routes into a stopping backend
        if self.gateway is not None:
            self.gateway.stop()
        self.server.stop(drain_timeout=5.0)
        for b in self.backends:
            b["server"].stop(drain_timeout=2.0)
        if self.follower_server is not None:
            self.follower_server.stop(drain_timeout=2.0)
        shutil.rmtree(self._store_root, ignore_errors=True)

    # -- block production ---------------------------------------------- #

    def produce_block(self) -> int:
        """Grow the primary AND every live backend in lockstep: shared
        (k, seed, chain_id) makes the replicas byte-identical, and the
        produce lock makes a backend_restart atomic against growth."""
        with self._produce_lock:
            h = self.node.latest_height() + 1
            self.node.drain_mempool()
            self.node.grow()
            for b in self.backends:
                b["node"].drain_mempool()
                b["node"].grow()
            self.produced["blocks"] += 1
            return h

    # -- phase-boundary actions ---------------------------------------- #

    def _action_backend_restart(self) -> None:
        """Kill one extra backend and boot a fresh node over its store
        directory. Under the produce lock so the restart is atomic
        against growth; the gateway drops the victim BEFORE its server
        stops, so new routes avoid it and in-flight ones hedge."""
        from celestia_tpu_torch.node.rpc import RpcServer

        idx = self._restart_rr % len(self.backends)
        self._restart_rr += 1
        b = self.backends[idx]
        with self._produce_lock:
            node = b["node"]
            persisted = sorted(node.store.heights()) \
                if node.store is not None else []
            pre_dah = {h: node.block_dah(h).hash().hex() for h in persisted}
            self.gateway.remove_backend(b["url"])
            b["server"].stop(drain_timeout=2.0)
            # heights=0: the ONLY recovery path is the store re-index
            fresh = ScenarioNode(
                heights=0, k=self.scenario.k, seed=self.seed,
                chain_id=self.node.chain_id,
                mempool_cap=self.scenario.mempool_cap,
                store_dir=b["store_dir"],
            )
            server = RpcServer(
                fresh, port=0,
                queue_capacity=self.scenario.queue_capacity,
                default_deadline_s=self.scenario.default_deadline_s,
            )
            server.start()
            b["node"], b["server"] = fresh, server
            b["url"] = f"http://127.0.0.1:{server.port}"
            self.gateway.add_backend(b["url"])
        recovered = sorted(fresh.store.heights()) \
            if fresh.store is not None else []
        self.restarts.append({
            "backend": idx, "url": b["url"],
            "pre_heights": persisted, "pre_dah": pre_dah,
            "recovered_heights": recovered,
        })

    # -- reporting ------------------------------------------------------ #

    def fleet_report(self) -> dict:
        return {
            "backends": 1 + len(self.backends),
            "gateway": self.url,
            "restarts": [
                {"backend": r["backend"], "url": r["url"],
                 "pre_heights": r["pre_heights"],
                 "recovered_heights": r["recovered_heights"]}
                for r in self.restarts
            ],
            "stores": [b["node"].store.stats() for b in self.backends
                       if b["node"].store is not None],
        }


class FleetProcessWorld(FleetWorld):
    """OS-process fleet world (ADR-023): supervised backend
    SUBPROCESSES behind the gateway instead of in-process servers.

    ``Scenario.fleet_processes = N`` selects this world. It boots with
    ONE supervised backend process on the ring; the in-process primary
    node still anchors the deterministic chain but is deliberately OFF
    the ring — it is the verification oracle every das client and
    invariant probe recomputes against, never a serving path. Block
    production is lockstep through ``FleetSupervisor.advance``: the
    primary grows, then every ready process proves the same extension
    in its own address space (shared (k, seed, chain_id) keeps the
    replica DAHs byte-identical by construction).

    The ``fleet_scale_out`` action grows the fleet to the target size
    ASYNCHRONOUSLY — the phase's flash crowd storms the gateway while
    each joiner spawns, re-indexes its store, backfills to the fleet
    head, and only then takes ring traffic (the warming contract,
    specs/serving.md). The ``fleet_scaled_out`` invariant audits the
    join events at teardown: every member reached ready, every join
    backfilled to at least the head it observed, and a pre-join height
    still NMT-verifies through the gateway after the ring grew."""

    def __init__(self, scenario: Scenario, seed: int, registry=None,
                 device=None):
        super().__init__(scenario, seed, registry=registry, device=device)
        self.supervisor = None  # built on start
        self._scale_thread: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------- #

    def start(self) -> None:
        from celestia_tpu_torch.node.fleet import FleetSupervisor
        from celestia_tpu_torch.node.gateway import Gateway

        self.server.start()  # the oracle: never added to the ring
        self.primary_url = f"http://127.0.0.1:{self.server.port}"
        self.gateway = Gateway([])
        self.gateway.start()
        self.url = self.gateway.url
        self.supervisor = FleetSupervisor(
            1, os.path.join(self._store_root, "procs"),
            gateway=self.gateway, k=self.scenario.k,
            heights=self.scenario.initial_heights, seed=self.seed,
            chain_id=self.node.chain_id, device=self.device,
        )
        self.supervisor.start()
        self.prober = self._prober_cls(
            self.url, samples_per_cycle=4, timeout=5.0,
            share_proofs=False, rng=self._prober_rng,
            registry=self.registry,
        )
        self._watch_thread = threading.Thread(target=self._watch_readyz,
                                              daemon=True)
        self._watch_thread.start()
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
        if self._scale_thread is not None:
            self._scale_thread.join(timeout=60)
        # supervisor first: it detaches members from the ring before
        # stopping them, so nothing routes into a dying process
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.gateway is not None:
            self.gateway.stop()
        self.server.stop(drain_timeout=5.0)
        if self.follower_server is not None:
            self.follower_server.stop(drain_timeout=2.0)
        shutil.rmtree(self._store_root, ignore_errors=True)

    def freeze(self) -> None:
        # let an in-flight scale-out land before heights are declared
        # stable: joiners warm to the frozen head, then the probes run
        super().freeze()
        if self._scale_thread is not None:
            self._scale_thread.join(timeout=60)

    # -- block production ---------------------------------------------- #

    def produce_block(self) -> int:
        """Grow the oracle, then fan the new height out to every ready
        process. No mempool drain: the subprocess replicas cannot see
        the primary's mempool, and spec validation keeps pfb load off
        process-fleet scenarios, so the chain stays seed-pure."""
        with self._produce_lock:
            self.node.grow()
            h = self.node.latest_height()
            self.produced["blocks"] += 1
        self.supervisor.advance(h)
        return h

    # -- phase-boundary actions ---------------------------------------- #

    def _action_fleet_scale_out(self) -> None:
        """Grow the fleet to ``scenario.fleet_processes`` WITHOUT
        blocking the phase: the storm must overlap the join window —
        that is the scenario's whole point."""
        target = self.scenario.fleet_processes

        def scale() -> None:
            try:
                self.supervisor.scale_to(target)
            except Exception:  # noqa: BLE001 — the invariant judges it
                pass

        self._scale_thread = threading.Thread(target=scale, daemon=True)
        self._scale_thread.start()

    # -- reporting ------------------------------------------------------ #

    def fleet_report(self) -> dict:
        doc = self.supervisor.report() if self.supervisor else {}
        doc["gateway"] = self.url
        doc["oracle"] = self.primary_url
        return doc
