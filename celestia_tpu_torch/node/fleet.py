"""Multi-process fleet supervisor (ADR-023; port of the JAX package's
node/fleet.py).

The first component that makes "fleet" mean OS processes: a
`FleetSupervisor` launches N backend processes (each serving the real
`node/rpc.py` HTTP surface on its own port, over its OWN durable store
directory), health-checks them via `/readyz`, restarts crashed members
with exponential backoff + crash-loop detection, and drives
`Gateway.add_backend` / `remove_backend` so consistent-hash ring
membership tracks LIVE processes — never a URL whose process is gone.

Membership is elastic, and elasticity is what the warming contract
protects: a (re)joining member first re-indexes its store (adopting
every height it persisted before the crash), is then driven to the
fleet head with `grow` commands (backfilling hot heights from the
deterministic chain / its store), and only after `/readyz` answers 200
at the head does the supervisor call `add_backend`. Until that moment
the member is **warming** — reachable, but owning no ring arc — so a
scale-out under flash-crowd load never routes a sample to a replica
that cannot serve it. Removal is the mirror image: `remove_backend`
first (new routing decisions skip the member), then graceful stop, so
requests in flight on stale candidate snapshots hedge to the next ring
position instead of failing.

Worker protocol (the `--backend` mode of ``python -m
celestia_tpu_torch.node.fleet``): the child boots an `RpcChaosNode` (the
crypto-free deterministic DA chain — byte-identical replicas given the
same k/seed) behind the REAL `RpcServer`, prints ``PORT <n>`` once
serving, then obeys newline commands on stdin. Its ``--device`` (the
supervisor's ``device``; None means ``cuda``) is resolved first, so a
backend asked for CUDA on a host without a GPU exits before it serves;
the backend is store-backed and non-paged, so it does host work only:

    grow <h>        append heights until latest_height >= h
                    (auto-compacts when --store-budget is set)
    compact <b> <r> run store.compact(byte_budget=b, keep_recent=r)
    drain           dispatcher stops admitting (503 sheds)
    readonly on|off force the store read-only / try to recover it
                    (the storage-degradation drill lever, ADR-026)
    stop            graceful stop; write the trace file; exit

Supervisor member states::

    starting -> warming -> ready <-> degraded
        ^          |         |
        |       (crash)   (crash)
        +--- backoff <-------+        backoff doubles 2x per crash
                |                     (capped), resets after a
            crashloop (terminal)      crash-free window

Storage degradation (ADR-026) is NOT a crash: a member whose `/readyz`
answers 503 failing ONLY the `store_writable` check still serves every
read it has — restarting it would trade a full cache for the same full
disk. The supervisor classifies it **degraded**: it keeps its ring
arcs (reads keep routing to it), keeps being probed, and is excluded
from `advance()` head adoption (a read-only store cannot persist new
heights) until `/readyz` recovers to 200 — then it is re-warmed to the
fleet head and promoted back to ready. Degraded members never count
toward `fleet_health_fail_total` or the crash-loop ledger.

Fault sites (specs/faults.md): `fleet.spawn` fires before each process
launch (error rules model a fork/exec failure; delay rules a slow
boot); `fleet.health` fires before each `/readyz` probe of a ready
member (an error rule models the health checker itself failing — the
probe counts as failed, the member is NOT restarted: only process exit
triggers a restart).

Locking: `fleet._lock` guards the member table, the fleet head and the
event ledger; it is the OUTERMOST lock in the specs/serving.md
declared order and is NEVER held across process I/O, an HTTP probe, a
gateway membership call or a fault site — every operation snapshots
under the lock, acts unlocked, then commits under the lock.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

from celestia_tpu_torch import faults
from celestia_tpu_torch.log import logger
from celestia_tpu_torch.telemetry import metrics

log = logger("fleet")

# member states
STARTING = "starting"
WARMING = "warming"
READY = "ready"
DEGRADED = "degraded"
BACKOFF = "backoff"
CRASHLOOP = "crashloop"
STOPPED = "stopped"


def _http_status(url: str, timeout: float) -> int:
    """Status code of one GET; HTTP error codes are answers."""
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _http_get_json(url: str, timeout: float):
    """(status, parsed body) of one GET; HTTP error codes are answers
    and their bodies are read too — /readyz 503s carry the check list
    that tells storage degradation apart from real sickness."""
    import json
    import urllib.error

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except ValueError:
            return e.code, {}


class FleetMember:
    """One supervised backend process (mutated by the supervisor's
    health thread only, except during single-threaded bring-up)."""

    def __init__(self, index: int, store_dir: pathlib.Path):
        self.index = index
        self.store_dir = store_dir
        self.proc: subprocess.Popen | None = None
        self.port: int | None = None
        self.url: str | None = None
        self.state = STARTING
        self.generation = 0          # bumps on every (re)spawn
        self.restarts = 0
        self.health_fails = 0
        self.healthy = True
        self.backoff_s = 0.0
        self.restart_at = 0.0
        self.crash_times: list[float] = []
        self.ready_since = 0.0
        self.last_exit: int | None = None
        self.trace_files: list[str] = []

    def pid(self) -> int | None:
        return self.proc.pid if self.proc is not None else None

    def doc(self) -> dict:
        return {
            "index": self.index, "pid": self.pid(), "port": self.port,
            "url": self.url, "state": self.state,
            "generation": self.generation, "restarts": self.restarts,
            "health_fails": self.health_fails, "healthy": self.healthy,
            "last_exit": self.last_exit,
            "store_dir": str(self.store_dir),
        }


class FleetSupervisor:
    """Launch, health-check, restart and (de)register N backend
    processes; ring membership tracks live processes."""

    def __init__(self, size: int, store_root, *, gateway=None,
                 k: int = 8, heights: int = 1, seed: int = 7,
                 chain_id: str = "fleet", command=None,
                 python: str | None = None,
                 ready_timeout_s: float = 60.0,
                 health_interval_s: float = 0.25,
                 health_timeout_s: float = 2.0,
                 backoff_base_s: float = 0.25,
                 backoff_max_s: float = 8.0,
                 crash_loop_limit: int = 5,
                 crash_loop_window_s: float = 30.0,
                 store_budget_bytes: int | None = None,
                 keep_recent: int = 16,
                 trace_dir=None,
                 device=None):
        self.size = int(size)
        self.store_root = pathlib.Path(store_root)
        self.gateway = gateway
        self.k = int(k)
        self.heights = int(heights)
        self.seed = int(seed)
        self.chain_id = chain_id
        self.command = command  # callable(member) -> argv, or None
        self.python = python or sys.executable
        self.ready_timeout_s = float(ready_timeout_s)
        self.health_interval_s = float(health_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.crash_loop_limit = int(crash_loop_limit)
        self.crash_loop_window_s = float(crash_loop_window_s)
        self.store_budget_bytes = store_budget_bytes
        self.keep_recent = int(keep_recent)
        self.trace_dir = pathlib.Path(trace_dir) if trace_dir else None
        self.device = "cuda" if device is None else str(device)
        self._lock = threading.Lock()
        self._members: list[FleetMember] = []
        self._head = 0
        self._events: list[dict] = []
        self._spawns = 0
        self._restarts = 0
        self._crashloops = 0
        self._t0 = time.monotonic()
        self._stop_evt = threading.Event()
        self._health_thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------ #

    def start(self) -> "FleetSupervisor":
        self.store_root.mkdir(parents=True, exist_ok=True)
        if self.trace_dir is not None:
            self.trace_dir.mkdir(parents=True, exist_ok=True)
        with self._lock:
            self._head = self.heights
        for i in range(self.size):
            self.scale_out()
        self._stop_evt.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="fleet-health")
        self._health_thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10.0)
            self._health_thread = None
        with self._lock:
            members = list(self._members)
        for m in members:
            self._detach(m)
            self._stop_member(m)
        self._publish()

    # -- elastic membership --------------------------------------------- #

    def scale_out(self) -> FleetMember:
        """Spawn one member, warm it to the fleet head, then attach it
        to the ring. Raises on boot failure (once a member is LISTED,
        the health loop owns its restarts)."""
        with self._lock:
            index = len(self._members)
            head = self._head
        member = FleetMember(index, self.store_root / f"member{index}")
        self._spawn(member)
        warmed_to = self._warm(member, head)
        self._attach(member)
        with self._lock:
            self._members.append(member)
            self._events.append({
                "event": "join", "member": index, "pid": member.pid(),
                "head": head, "warmed_to": warmed_to,
                "t": round(time.monotonic() - self._t0, 3)})
        self._publish()
        return member

    def scale_in(self) -> str | None:
        """Detach the newest ready member from the ring first (new
        routing decisions skip it), then stop the process — in-flight
        requests on stale candidate snapshots hedge cleanly."""
        with self._lock:
            ready = [m for m in self._members if m.state == READY]
            if not ready:
                return None
            member = ready[-1]
            member.state = STOPPED
        self._detach(member)
        self._stop_member(member)
        with self._lock:
            self._members.remove(member)
            self._events.append({
                "event": "leave", "member": member.index,
                "t": round(time.monotonic() - self._t0, 3)})
        self._publish()
        return member.url

    def scale_to(self, n: int) -> None:
        while True:
            with self._lock:
                cur = len(self._members)
            if cur < n:
                self.scale_out()
            elif cur > n:
                self.scale_in()
            else:
                return

    # -- block production ----------------------------------------------- #

    def advance(self, height: int) -> int:
        """Drive every ready member to `height` in lockstep (the
        producer analogue: replicas of the deterministic chain are
        byte-identical at any height). Returns the new fleet head."""
        with self._lock:
            self._head = max(self._head, int(height))
            head = self._head
            targets = [(m, m.proc) for m in self._members
                       if m.state == READY]

        def grow_one(proc) -> None:
            try:
                self._cmd(proc, f"grow {head}")
            except (OSError, ValueError):
                pass  # a crash mid-grow is the health loop's job

        # fan out concurrently: each member proves the same extension on
        # its own core, so the block stream costs max(member) not
        # sum(members) — this is what keeps fleet blocks/sec flat as the
        # process count grows
        growers = [threading.Thread(target=grow_one, args=(proc,),
                                    daemon=True)
                   for _, proc in targets]
        for t in growers:
            t.start()
        for t in growers:
            t.join()
        return head

    @property
    def head(self) -> int:
        with self._lock:
            return self._head

    # -- health loop ---------------------------------------------------- #

    def _health_loop(self) -> None:
        while not self._stop_evt.wait(self.health_interval_s):
            try:
                self.health_check_once()
            except Exception as e:  # noqa: BLE001 — the supervisor
                # must outlive any single check; a dead health loop is
                # a silent fleet
                log.warn("fleet health pass failed", error=str(e))

    def health_check_once(self) -> None:
        """One supervision pass: reap crashed members into backoff,
        restart those whose backoff expired, probe the ready ones."""
        with self._lock:
            snapshot = list(self._members)
        now = time.monotonic()
        for m in snapshot:
            if m.state in (CRASHLOOP, STOPPED):
                continue
            proc = m.proc
            if proc is not None and proc.poll() is not None \
                    and m.state in (READY, DEGRADED, WARMING, STARTING):
                self._on_crash(m, proc.returncode)
                continue
            if m.state == BACKOFF:
                if now >= m.restart_at:
                    self._restart(m)
                continue
            if m.state in (READY, DEGRADED):
                self._probe(m, now)
        self._publish()

    def _probe(self, m: FleetMember, now: float) -> None:
        status, failing = -1, set()
        try:
            faults.fire("fleet.health", member=m.index, url=m.url)
            status, body = _http_get_json(m.url + "/readyz",
                                          timeout=self.health_timeout_s)
            failing = {c.get("name") for c in body.get("checks", ())
                       if not c.get("ok", False)}
        except Exception:  # noqa: BLE001 — a failing health checker
            # (armed error rule, dead socket) is a failed probe, not a
            # supervisor crash; only process EXIT triggers a restart
            status = -1
        # a 503 failing ONLY store_writable is storage degradation, not
        # sickness: the member still serves every read it has (ADR-026)
        storage_only = (status == 503 and failing
                        and failing <= {"store_writable"})
        if m.state == DEGRADED:
            if status == 200:
                self._recover(m)
            elif storage_only:
                m.healthy = True  # still degraded, still serving reads
            else:
                m.healthy = False
                m.health_fails += 1
                metrics.incr_counter("fleet_health_fail_total")
            return
        if storage_only:
            self._degrade(m)
            return
        ok = status == 200
        m.healthy = ok
        if not ok:
            m.health_fails += 1
            metrics.incr_counter("fleet_health_fail_total")
        elif m.ready_since and \
                now - m.ready_since > self.crash_loop_window_s:
            m.backoff_s = 0.0        # stable: forgive crash history
            m.crash_times = [t for t in m.crash_times
                             if now - t <= self.crash_loop_window_s]

    def _degrade(self, m: FleetMember) -> None:
        """READY -> DEGRADED: keep the ring arcs (reads keep routing),
        keep probing, exclude from head adoption; no restart, no
        health-fail accounting — a full cache beats an empty one."""
        m.state = DEGRADED
        m.healthy = True
        metrics.incr_counter("fleet_degraded_total")
        log.warn("fleet member storage-degraded; serving reads, "
                 "excluded from head adoption", member=m.index)
        with self._lock:
            self._events.append({
                "event": "degraded", "member": m.index,
                "check": "store_writable",
                "t": round(time.monotonic() - self._t0, 3)})

    def _recover(self, m: FleetMember) -> None:
        """DEGRADED -> READY: the store is writable again; re-warm to
        the fleet head it missed while degraded, then promote."""
        with self._lock:
            head = self._head
        try:
            warmed_to = self._warm(m, head)
        except Exception as e:  # noqa: BLE001 — a failed re-warm keeps
            # the member degraded; the next probe pass retries and a
            # mid-warm crash is caught by the poll() reaper
            log.warn("fleet member recovery warm failed",
                     member=m.index, error=str(e))
            return
        m.state = READY
        m.healthy = True
        m.ready_since = time.monotonic()
        log.info("fleet member recovered from storage degradation",
                 member=m.index, warmed_to=warmed_to)
        with self._lock:
            self._events.append({
                "event": "recovered", "member": m.index,
                "warmed_to": warmed_to,
                "t": round(time.monotonic() - self._t0, 3)})

    def _on_crash(self, m: FleetMember, code: int | None) -> None:
        m.last_exit = code
        self._detach(m)
        now = time.monotonic()
        m.crash_times = [t for t in m.crash_times
                         if now - t <= self.crash_loop_window_s]
        m.crash_times.append(now)
        if len(m.crash_times) > self.crash_loop_limit:
            m.state = CRASHLOOP
            metrics.incr_counter("fleet_crashloop_total")
            log.warn("fleet member crash-looping; giving up",
                     member=m.index, crashes=len(m.crash_times))
            with self._lock:
                self._crashloops += 1
                self._events.append({
                    "event": "crashloop", "member": m.index,
                    "t": round(now - self._t0, 3)})
            return
        m.backoff_s = min(self.backoff_max_s,
                          m.backoff_s * 2 if m.backoff_s
                          else self.backoff_base_s)
        m.restart_at = now + m.backoff_s
        m.state = BACKOFF
        log.warn("fleet member exited; restart scheduled",
                 member=m.index, exit=code, backoff_s=m.backoff_s)
        with self._lock:
            self._events.append({
                "event": "crash", "member": m.index, "exit": code,
                "backoff_s": m.backoff_s,
                "t": round(now - self._t0, 3)})

    def _restart(self, m: FleetMember) -> None:
        m.state = STARTING
        try:
            self._spawn(m)
            with self._lock:
                head = self._head
            warmed_to = self._warm(m, head)
        except Exception as e:  # noqa: BLE001 — a failed respawn goes
            # back to backoff (doubled), not through the health loop
            m.backoff_s = min(self.backoff_max_s,
                              m.backoff_s * 2 if m.backoff_s
                              else self.backoff_base_s)
            m.restart_at = time.monotonic() + m.backoff_s
            m.state = BACKOFF
            log.warn("fleet member respawn failed", member=m.index,
                     error=str(e))
            return
        self._attach(m)
        m.restarts += 1
        metrics.incr_counter("fleet_restart_total")
        with self._lock:
            self._restarts += 1
            self._events.append({
                "event": "restart", "member": m.index,
                "pid": m.pid(), "warmed_to": warmed_to,
                "t": round(time.monotonic() - self._t0, 3)})

    # -- process plumbing ----------------------------------------------- #

    def _argv(self, member: FleetMember) -> list[str]:
        if self.command is not None:
            return list(self.command(member))
        argv = [self.python, "-m", "celestia_tpu_torch.node.fleet",
                "--backend", "--store-dir", str(member.store_dir),
                "--k", str(self.k), "--heights", str(self.heights),
                "--seed", str(self.seed), "--chain-id", self.chain_id,
                "--device", self.device]
        if self.store_budget_bytes:
            argv += ["--store-budget", str(self.store_budget_bytes),
                     "--keep-recent", str(self.keep_recent)]
        if self.trace_dir is not None:
            path = str(self.trace_dir /
                       f"backend{member.index}.gen{member.generation}.json")
            member.trace_files.append(path)
            argv += ["--trace-out", path]
        return argv

    def _spawn(self, member: FleetMember) -> None:
        """Launch the member's process and wait for its PORT line.
        The `fleet.spawn` drill fires BEFORE the fork/exec so error
        rules model a spawn that never produces a process."""
        faults.fire("fleet.spawn", member=member.index,
                    generation=member.generation)
        member.store_dir.mkdir(parents=True, exist_ok=True)
        member.generation += 1
        argv = self._argv(member)
        stderr = open(member.store_dir / "stderr.log", "ab")
        try:
            member.proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=stderr, text=True)
        finally:
            stderr.close()
        member.state = STARTING
        port = self._read_port(member.proc, self.ready_timeout_s)
        member.port = port
        member.url = f"http://127.0.0.1:{port}"
        member.state = WARMING
        metrics.incr_counter("fleet_spawn_total")
        with self._lock:
            self._spawns += 1
        log.info("fleet member spawned", member=member.index,
                 pid=member.pid(), port=port)

    @staticmethod
    def _read_port(proc: subprocess.Popen, timeout: float) -> int:
        box: dict[str, int] = {}

        def reader() -> None:
            for line in proc.stdout:
                line = line.strip()
                if line.startswith("PORT "):
                    box["port"] = int(line.split()[1])
                    return

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        t.join(timeout)
        if "port" not in box:
            raise RuntimeError(
                f"backend pid={proc.pid} did not report a port within "
                f"{timeout:.0f}s (exit={proc.poll()})")
        return box["port"]

    @staticmethod
    def _cmd(proc: subprocess.Popen, word: str) -> str:
        proc.stdin.write(word + "\n")
        proc.stdin.flush()
        return (proc.stdout.readline() or "").strip()

    def _warm(self, member: FleetMember, head: int) -> int:
        """The warming contract: backfill to the fleet head, then wait
        for `/readyz` 200 — only then may the member own ring arcs."""
        warmed_to = head
        if head:
            reply = self._cmd(member.proc, f"grow {head}")
            if not reply.startswith("OK grow"):
                raise RuntimeError(
                    f"member {member.index} failed to warm to height "
                    f"{head}: {reply!r}")
            parts = reply.split()
            if len(parts) == 3:
                warmed_to = int(parts[2])
        deadline = time.monotonic() + self.ready_timeout_s
        while time.monotonic() < deadline:
            try:
                if _http_status(member.url + "/readyz",
                                timeout=self.health_timeout_s) == 200:
                    return warmed_to
            except OSError:
                pass
            time.sleep(0.05)
        raise TimeoutError(
            f"member {member.index} not ready within "
            f"{self.ready_timeout_s:.0f}s")

    def _attach(self, member: FleetMember) -> None:
        if self.gateway is not None:
            self.gateway.add_backend(member.url)
        member.state = READY
        member.healthy = True
        member.ready_since = time.monotonic()

    def _detach(self, member: FleetMember) -> None:
        if self.gateway is not None and member.url:
            try:
                self.gateway.remove_backend(member.url)
            except Exception:  # noqa: BLE001 — a gateway mid-teardown
                pass

    def _stop_member(self, member: FleetMember) -> None:
        proc = member.proc
        if proc is None:
            return
        if proc.poll() is None:
            try:
                self._cmd(proc, "stop")
            except (OSError, ValueError):
                pass
            try:
                proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
        for stream in (proc.stdin, proc.stdout):
            try:
                if stream is not None:
                    stream.close()
            except OSError:
                pass
        member.state = STOPPED

    # -- introspection -------------------------------------------------- #

    def members(self) -> list[FleetMember]:
        with self._lock:
            return list(self._members)

    def member_states(self) -> list[str]:
        with self._lock:
            return [m.state for m in self._members]

    def wait_ready(self, index: int, timeout: float, *,
                   min_generation: int = 0) -> bool:
        """Block until member `index` is READY (the SIGKILL-restart
        gate's lever) — returns False on timeout or crash-loop. Pass
        `min_generation` = the pre-kill generation + 1 to wait for the
        RESTARTED process rather than racing crash detection."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                members = list(self._members)
            state = gen = None
            for m in members:
                if m.index == index:
                    state, gen = m.state, m.generation
            if state == READY and (gen or 0) >= min_generation:
                return True
            if state == CRASHLOOP:
                return False
            time.sleep(0.05)
        return False

    def trace_files(self) -> list[str]:
        """Every backend trace file a graceful stop wrote (a SIGKILL'd
        generation never writes; its restarted generation does)."""
        with self._lock:
            members = list(self._members)
        out: list[str] = []
        for m in members:
            out.extend(p for p in m.trace_files if os.path.exists(p))
        return out

    def report(self) -> dict:
        with self._lock:
            return {
                "kind": "fleet",
                "members": [m.doc() for m in self._members],
                "head": self._head,
                "spawns": self._spawns,
                "restarts": self._restarts,
                "crashloops": self._crashloops,
                "events": list(self._events),
            }

    def _publish(self) -> None:
        with self._lock:
            n = len(self._members)
            ready = sum(1 for m in self._members if m.state == READY)
            degraded = sum(1 for m in self._members
                           if m.state == DEGRADED)
        metrics.set_gauge("fleet_members", float(n))
        metrics.set_gauge("fleet_members_ready", float(ready))
        metrics.set_gauge("fleet_members_degraded", float(degraded))


# -- worker mode --------------------------------------------------------- #

def backend_main(args) -> int:
    """One fleet backend process: RpcChaosNode (crypto-free, store-
    backed) behind the real RpcServer, driven over stdin."""
    from celestia_tpu_torch import device as device_mod
    from celestia_tpu_torch import tracing
    from celestia_tpu_torch.node.rpc import RpcServer
    from celestia_tpu_torch.testutil.chaosnet import RpcChaosNode

    device_mod.resolve(args.device)  # None/"cuda" without a GPU raises here
    node = RpcChaosNode(heights=args.heights, k=args.k, seed=args.seed,
                        chain_id=args.chain_id,
                        store_dir=args.store_dir)
    server = RpcServer(node, port=args.port)
    rec = tracing.record().start() if args.trace_out else None
    server.start()
    print(f"PORT {server.port}", flush=True)

    def compact(budget: int, keep: int) -> dict:
        if node.store is None or not budget:
            return {}
        return node.store.compact(budget, keep_recent=keep)

    try:
        for line in sys.stdin:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "grow":
                target = int(parts[1]) if len(parts) > 1 else \
                    node.latest_height() + 1
                while node.latest_height() < target:
                    node.grow()
                if args.store_budget:
                    compact(args.store_budget, args.keep_recent)
                print(f"OK grow {node.latest_height()}", flush=True)
            elif parts[0] == "compact":
                budget = int(parts[1])
                keep = int(parts[2]) if len(parts) > 2 else 16
                rep = compact(budget, keep)
                print(f"OK compact {rep.get('evicted', 0)}", flush=True)
            elif parts[0] == "drain":
                server.dispatcher.begin_drain()
                print("OK drain", flush=True)
            elif parts[0] == "readonly":
                if node.store is None:
                    print("ERR no store", flush=True)
                elif len(parts) > 1 and parts[1] == "on":
                    node.store.force_read_only("operator")
                    print("OK readonly on", flush=True)
                else:
                    ok = node.store.try_recover()
                    print(f"OK readonly off {int(ok)}", flush=True)
            elif parts[0] == "stop":
                break
            else:
                print(f"ERR unknown {parts[0]}", flush=True)
    finally:
        server.stop(drain_timeout=2.0)
        if rec is not None:
            rec.stop()
            rec.write(args.trace_out)
        print("OK stop", flush=True)
    return 0


def main(argv=None) -> int:
    """``python -m celestia_tpu_torch.node.fleet``: either one worker
    (--backend) or a foreground supervisor + gateway devnet — what
    scripts/multi-node.sh boots."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", action="store_true",
                    help="internal: run as one supervised backend")
    ap.add_argument("--processes", type=int, default=3)
    ap.add_argument("--store-root", default=None,
                    help="fleet store root (default: a temp dir)")
    ap.add_argument("--store-dir", default=None,
                    help="backend mode: this member's store dir")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--heights", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chain-id", default="fleet")
    ap.add_argument("--block-interval", type=float, default=1.0)
    ap.add_argument("--store-budget", type=int, default=0,
                    help="byte budget: auto-compact after each grow")
    ap.add_argument("--keep-recent", type=int, default=16)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the backends' device (cpu runs without a GPU)")
    args = ap.parse_args(argv)
    if args.backend:
        return backend_main(args)

    import tempfile

    from celestia_tpu_torch.node.gateway import Gateway

    store_root = args.store_root or tempfile.mkdtemp(prefix="fleet-")
    gw = Gateway(port=args.port)
    gw.start()
    sup = FleetSupervisor(
        args.processes, store_root, gateway=gw, k=args.k,
        heights=args.heights, seed=args.seed, chain_id=args.chain_id,
        store_budget_bytes=args.store_budget or None,
        keep_recent=args.keep_recent, device=args.device)
    sup.start()
    print(f"gateway {gw.url}")
    for m in sup.members():
        print(f"member{m.index} pid={m.pid()} {m.url}")
    print("producing blocks; Ctrl-C to stop", flush=True)
    try:
        while True:
            time.sleep(args.block_interval)
            sup.advance(sup.head + 1)
    except KeyboardInterrupt:
        pass
    finally:
        sup.stop()
        gw.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
