"""The port's process fleet (``celestia_tpu_torch/node/fleet.py``) against
the JAX package's, on the CPU.

The supervisor's member state machine runs unit-level on both packages (no
subprocesses): backoff doubling and its cap, crash-loop detection and its
window, a stable member forgiving its history, a failed probe that counts but
never restarts, and the storage-degraded classification over a real store.
The worker's stdin protocol (``grow``, ``compact``, ``drain``, ``readonly``,
``stop`` and an unknown word) answers the JAX worker's replies line for line.
Then port backends run as real processes with ``--device cpu``: a two-member
fleet behind the port's gateway serves the chain's DAH, a killed member
restarts, a scale-out backfills the joiner to the fleet head before it takes
ring traffic, and a store a member compacts keeps the JAX chain's DAHs. A
backend asked for CUDA on this host without a GPU exits before it serves.
"""

import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from celestia_tpu.node import fleet as jfleet
from celestia_tpu.node.rpc import RpcServer as JServer
from celestia_tpu.telemetry import metrics as jmetrics
from celestia_tpu.testutil.chaosnet import RpcChaosNode as JNode
from celestia_tpu_torch.node import fleet as pfleet
from celestia_tpu_torch.node.gateway import Gateway
from celestia_tpu_torch.node.rpc import RpcServer as PServer
from celestia_tpu_torch.telemetry import metrics as pmetrics
from celestia_tpu_torch.testutil.chaosnet import RpcChaosNode as PNode

PKGS = {"jax": (jfleet, JServer, JNode, jmetrics), "port": (pfleet, PServer, PNode, pmetrics)}


def _get(url: str, timeout: float = 10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _sup(pkg, tmp_path, **kw):
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_max_s", 0.4)
    return PKGS[pkg][0].FleetSupervisor(0, tmp_path / "fleet", **kw)


def _member(pkg, sup):
    m = PKGS[pkg][0].FleetMember(0, sup.store_root / "m0")
    with sup._lock:
        sup._members.append(m)
    return m


def _backend(pkg, tmp_path=None, name=None):
    _mod, server_cls, node_cls, _metrics = PKGS[pkg]
    node = node_cls(heights=2, k=4, seed=7, chain_id="fleet-t",
                    store_dir=str(tmp_path / name) if name else None)
    server = server_cls(node, port=0)
    server.start()
    return node, server, f"http://127.0.0.1:{server.port}"


def test_the_member_states_are_the_jax_states():
    for name in ("STARTING", "WARMING", "READY", "DEGRADED", "BACKOFF", "CRASHLOOP",
                 "STOPPED"):
        assert getattr(pfleet, name) == getattr(jfleet, name)


@pytest.mark.parametrize("pkg", ["jax", "port"])
class TestSupervisorStateMachine:
    def test_backoff_doubles_then_caps(self, pkg, tmp_path):
        sup = _sup(pkg, tmp_path)
        m = _member(pkg, sup)
        seen = []
        for _ in range(5):
            m.state = pfleet.READY
            sup._on_crash(m, 1)
            seen.append(m.backoff_s)
            assert m.state == pfleet.BACKOFF
            m.crash_times.clear()
        assert seen == [0.05, 0.1, 0.2, 0.4, 0.4]

    def test_crash_loop_detection_gives_up(self, pkg, tmp_path):
        sup = _sup(pkg, tmp_path, crash_loop_limit=2, crash_loop_window_s=30.0)
        m = _member(pkg, sup)
        for _ in range(2):
            m.state = pfleet.READY
            sup._on_crash(m, -9)
            assert m.state == pfleet.BACKOFF
        m.state = pfleet.READY
        sup._on_crash(m, -9)
        assert m.state == pfleet.CRASHLOOP
        report = sup.report()
        assert report["crashloops"] == 1
        assert [e["event"] for e in report["events"]] == ["crash", "crash", "crashloop"]
        sup.health_check_once()
        assert m.state == pfleet.CRASHLOOP

    def test_old_crashes_age_out_of_the_window(self, pkg, tmp_path):
        sup = _sup(pkg, tmp_path, crash_loop_limit=2, crash_loop_window_s=0.2)
        m = _member(pkg, sup)
        for _ in range(2):
            m.state = pfleet.READY
            sup._on_crash(m, 1)
        time.sleep(0.25)
        m.state = pfleet.READY
        sup._on_crash(m, 1)
        assert m.state == pfleet.BACKOFF

    def test_stable_member_forgives_crash_history(self, pkg, tmp_path):
        _node, server, url = _backend(pkg)
        sup = _sup(pkg, tmp_path, crash_loop_window_s=0.1)
        m = _member(pkg, sup)
        m.state, m.url, m.backoff_s = pfleet.READY, url, 0.4
        m.ready_since = time.monotonic() - 1.0
        m.crash_times = [time.monotonic() - 5.0]
        try:
            sup._probe(m, time.monotonic())
            assert m.healthy and m.backoff_s == 0.0 and m.crash_times == []
        finally:
            server.stop(drain_timeout=0.5)

    def test_failed_probe_counts_but_never_restarts(self, pkg, tmp_path):
        metrics = PKGS[pkg][3]
        sup = _sup(pkg, tmp_path)
        m = _member(pkg, sup)
        m.state, m.url = pfleet.READY, "http://127.0.0.1:9"
        before = metrics.get_counter("fleet_health_fail_total")
        sup._probe(m, time.monotonic())
        assert not m.healthy and m.health_fails == 1 and m.state == pfleet.READY
        assert metrics.get_counter("fleet_health_fail_total") == before + 1

    def test_storage_degraded_probe_demotes_then_recovers(self, pkg, tmp_path):
        metrics = PKGS[pkg][3]
        node, server, url = _backend(pkg, tmp_path, name="m0")
        sup = _sup(pkg, tmp_path)
        m = _member(pkg, sup)
        m.state, m.url = pfleet.READY, url
        fails0 = metrics.get_counter("fleet_health_fail_total")
        try:
            node.store.force_read_only("operator")
            sup._probe(m, time.monotonic())
            assert m.state == pfleet.DEGRADED and m.healthy and m.health_fails == 0
            sup._publish()
            assert metrics.get_gauge("fleet_members_degraded") == 1.0
            # beyond storage (the device's sticky disable) is a failed probe
            strike = "_tpu_disabled" if pkg == "jax" else "_gpu_disabled"
            setattr(node.app, strike, True)
            sup._probe(m, time.monotonic())
            assert m.state == pfleet.DEGRADED and not m.healthy
            assert metrics.get_counter("fleet_health_fail_total") == fails0 + 1
            setattr(node.app, strike, False)
            assert node.store.try_recover()
            sup._probe(m, time.monotonic())
            assert m.state == pfleet.READY
            assert [e["event"] for e in sup.report()["events"]] == ["degraded", "recovered"]
        finally:
            server.stop(drain_timeout=0.5)


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_the_worker_argv_names_the_port_and_its_device(tmp_path, device):
    sup = pfleet.FleetSupervisor(1, tmp_path, k=4, heights=2, seed=3, chain_id="c",
                                 device=device, store_budget_bytes=1 << 20, trace_dir=tmp_path)
    member = pfleet.FleetMember(0, tmp_path / "member0")
    argv = sup._argv(member)
    jargv = jfleet.FleetSupervisor(1, tmp_path, k=4, heights=2, seed=3, chain_id="c",
                                   store_budget_bytes=1 << 20, trace_dir=tmp_path)._argv(member)
    assert argv[:3] == [sys.executable, "-m", "celestia_tpu_torch.node.fleet"]
    at = argv.index("--device")
    assert argv[at + 1] == (device or "cuda")
    assert argv[3:at] + argv[at + 2:] == jargv[3:]


SCRIPT = "grow 3\ncompact 0 2\ngrow\ncompact 1 2\nreadonly on\nreadonly off\ndrain\nbogus\nstop\n"


def _replies(module: str, store_dir, extra=()):
    out = subprocess.run(
        [sys.executable, "-m", module, "--backend", "--k", "4", "--heights", "2",
         "--seed", "7", "--store-dir", str(store_dir), *extra],
        input=SCRIPT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("PORT ")
    return lines[1:]


def test_the_stdin_protocol_answers_the_jax_replies(tmp_path):
    port = _replies("celestia_tpu_torch.node.fleet", tmp_path / "p", ("--device", "cpu"))
    jax = _replies("celestia_tpu.node.fleet", tmp_path / "j")
    assert port == jax
    assert port == ["OK grow 3", "OK compact 0", "OK grow 4", "OK compact 2", "OK readonly on",
                    "OK readonly off 1", "OK drain", "ERR unknown bogus", "OK stop"]


def test_a_backend_asked_for_cuda_without_a_gpu_exits_before_it_serves(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.node.fleet", "--backend", "--k", "2",
         "--store-dir", str(tmp_path)], input="stop\n", capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and "PORT" not in out.stdout
    assert "no CUDA device is available" in out.stderr
    sup = pfleet.FleetSupervisor(1, tmp_path / "fleet", k=2, heights=1, ready_timeout_s=60.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not report a port"):
        sup.start()
    assert time.monotonic() - t0 < 50.0  # the worker's exit ends the wait


def test_a_process_fleet_restarts_and_scales_out_with_backfill(tmp_path):
    """Port backends as real processes on the CPU, behind the port's gateway."""
    gw = Gateway([])
    gw.start()
    sup = pfleet.FleetSupervisor(2, tmp_path / "fleet", gateway=gw, k=4, heights=2, seed=7,
                                 chain_id="fleet-e2e", backoff_base_s=0.1, device="cpu")
    ref = JNode(heights=5, k=4, seed=7)
    try:
        sup.start()
        assert sup.member_states() == [pfleet.READY, pfleet.READY]
        assert sup.advance(4) == 4
        status, body = _get(gw.url + "/dah/4")
        assert status == 200 and json.loads(body) == ref.block_dah(4).to_json()
        victim = sup.members()[0]
        gen0 = victim.generation
        victim.proc.kill()
        assert sup.wait_ready(0, timeout=60.0, min_generation=gen0 + 1)
        assert sup.report()["restarts"] == 1
        sup.scale_to(3)
        joins = [e for e in sup.report()["events"] if e["event"] == "join"]
        assert len(joins) == 3 and joins[-1]["warmed_to"] == joins[-1]["head"] == 4
        joiner = sup.members()[-1]
        status, body = _get(joiner.url + "/dah/4")  # backfilled before the ring
        assert status == 200 and json.loads(body) == ref.block_dah(4).to_json()
        assert len(gw.ring) == 3
        status, body = _get(gw.url + "/sample/4/1/6")
        assert status == 200
        assert json.loads(body) == ref.sample_batch(4, [(1, 6)])[0]
        assert sup.scale_in() == joiner.url and len(gw.ring) == 2
        pmetrics_doc = sup.report()
        assert [m["state"] for m in pmetrics_doc["members"]] == [pfleet.READY] * 2
    finally:
        sup.stop()
        gw.stop()
    assert all(m.state == pfleet.STOPPED for m in sup.members())


class TestStoreCompaction:
    @staticmethod
    def _stores(tmp_path, heights):
        return (PNode(heights=heights, k=4, seed=7, store_dir=str(tmp_path / "p")).store,
                JNode(heights=heights, k=4, seed=7, store_dir=str(tmp_path / "j")).store)

    def test_compaction_holds_budget_like_jax(self, tmp_path):
        pstore, jstore = self._stores(tmp_path, 30)
        per = pstore.stats()["bytes"] // 30
        assert pstore.stats()["bytes"] == jstore.stats()["bytes"]
        reports = [s.compact(per * 10, keep_recent=4) for s in (pstore, jstore)]
        assert reports[0] == reports[1] and not reports[0]["over_budget"]
        assert pstore.heights() == jstore.heights()
        for h in pstore.heights():
            assert pstore.read_dah(h) == jstore.read_dah(h)

    @pytest.mark.parametrize("keep", [2, 3])
    def test_keep_recent_overrides_a_zero_budget(self, tmp_path, keep):
        pstore, jstore = self._stores(tmp_path, 8)
        assert pstore.compact(0, keep_recent=keep) == jstore.compact(0, keep_recent=keep)
        assert pstore.heights() == list(range(9 - keep, 9))
        with pytest.raises(KeyError):
            pstore.read_dah(1)
