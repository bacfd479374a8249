"""The port's prober (``node/prober.py``), SLO engine and readiness
(``slo.py``), Prometheus export (``telemetry``) and trace context and Chrome
export (``tracing``) against the JAX package's, on the CPU.

- ``prometheus_text`` is byte-equal to JAX's for the same registry script.
- A ``TraceContext`` header round-trips both ways; a malformed one is
  counted; a recording's Chrome export validates under both validators.
- ``SloEngine.evaluate`` (an injected clock) and ``evaluate_at`` (the same
  captured counter windows) judge like the JAX engine; the one renamed
  objective is ``gpu_not_sticky_disabled``.
- ``readiness`` answers the JAX checks check by check on twin nodes, in
  each unfit state; only the sticky check's text says ``gpu``.
- ``probe_cycle`` runs synchronously with a seeded ``random.Random`` against
  a port server and a JAX server over twin nodes (samples, share proofs and
  the host crosscheck): the same summaries and counters; a fault at the
  sample boundary drives the availability objective into breach.
- The prober thread's cadence is tested with an injected clock and wait:
  nothing here asserts a wall-clock rate.
"""

import json
import random
import threading
import time
import types

import pytest

import celestia_tpu.slo as jslo
import celestia_tpu.telemetry as jtel
from celestia_tpu import faults as jfaults
from celestia_tpu import tracing as jtracing
from celestia_tpu.node.prober import Prober as JProber
from celestia_tpu.node.rpc import RpcServer as JServer
import celestia_tpu_torch.slo as pslo
import celestia_tpu_torch.telemetry as ptel
from celestia_tpu_torch import faults as pfaults
from celestia_tpu_torch import tracing as ptracing
from celestia_tpu_torch.node.prober import Prober as PProber
from celestia_tpu_torch.node.rpc import RpcServer as PServer

from test_torch_node_blocks import Twins, pfb, send


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """A strict reader of the text format v0.0.4 as the registry writes it:
    every series line belongs to a family announced by HELP and TYPE;
    comment lines other than those are exemplars. Raises on anything else."""
    import re

    series: dict[str, list[tuple[dict, float]]] = {}
    typed: dict[str, str] = {}
    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')
    assert text.endswith("\n")
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ")
            if parts[1] == "TYPE":
                assert parts[3] in ("counter", "gauge", "histogram"), line
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("# EXEMPLAR "):
            continue
        m = line_re.match(line)
        assert m, line
        name, labels = m.group(1), {}
        if m.group(3):
            consumed = 0
            for lm in label_re.finditer(m.group(3)):
                labels[lm.group(1)] = lm.group(2)
                consumed = lm.end()
            assert consumed == len(m.group(3)), line
        family = re.sub(r"_(bucket|sum|count)$", "", name) if name not in typed else name
        assert family in typed, line
        series.setdefault(name, []).append((labels, float(m.group(4))))
    return series


def _registry_script(reg) -> None:
    reg.incr_counter("rpc_shed_total", 2, reason="queue_full")
    reg.incr_counter("rpc_shed_total", reason='de"ad\\line\n')
    reg.incr_counter("probe_sample_total", 5)
    reg.incr_counter("already_total")
    reg.set_gauge("rpc_inflight_requests", 3.0)
    reg.set_gauge("device_busy_ratio", 0.125, device="cuda:0")
    for v, stage in ((0.0002, "dispatch"), (0.003, "serialize"), (0.9, "dispatch"), (75.0, "x")):
        reg.observe("rpc_stage_ms", v, exemplar="ab" * 16, stage=stage)
    reg.observe("extend_block", 0.02)
    reg.counters["bare_written"] = 1.0  # a direct dict write


def test_prometheus_text_is_byte_equal_to_jax():
    ours, theirs = ptel.Registry(), jtel.Registry()
    for reg in (ours, theirs):
        _registry_script(reg)
    text = ours.prometheus_text()
    assert text == theirs.prometheus_text()
    series = parse_prometheus(text)
    assert series["rpc_shed_total"] == [({"reason": 'de\\"ad\\\\line\\n'}, 1.0),
                                        ({"reason": "queue_full"}, 2.0)]
    assert ("# EXEMPLAR rpc_stage_ms_seconds{stage=\"x\"} trace_id=" + "ab" * 16
            + " value=75.0") in text
    buckets = [v for labels, v in series["rpc_stage_ms_seconds_bucket"]
               if labels.get("stage") == "dispatch"]
    assert buckets[-1] == 2.0 and buckets == sorted(buckets)
    for reg_a, reg_b in ((ours, theirs),):
        fam_a = [(lab, h.counts, h.sum) for lab, h in reg_a.histogram_family("rpc_stage_ms")]
        fam_b = [(lab, h.counts, h.sum) for lab, h in reg_b.histogram_family("rpc_stage_ms")]
        assert fam_a == fam_b and len(fam_a) == 3
    ours.reset()
    assert ours.prometheus_text() == "\n"


def test_refresh_process_gauges_reads_procfs():
    reg = ptel.Registry()
    ptel.refresh_process_gauges(reg)
    jreg = jtel.Registry()
    jtel.refresh_process_gauges(jreg)
    for name in ("process_rss_bytes", "process_threads", "process_open_fds"):
        assert reg.get_gauge(name) > 0 and jreg.get_gauge(name) > 0


# ---- trace context and the Chrome export


def test_trace_context_round_trips_both_ways():
    for mint, extract in ((jtracing.mint, ptracing.extract), (ptracing.mint, jtracing.extract),
                          (ptracing.mint, ptracing.extract)):
        ctx = mint()
        got = extract(ctx.header_value())
        assert (got.trace_id, got.span_id, got.flags) == (ctx.trace_id, ctx.span_id, 1)
        assert got.header_value() == ctx.header_value()
    ctx = ptracing.extract("00-" + "AB" * 16 + "-" + "CD" * 8 + "-01")
    assert ctx.trace_id == "ab" * 16 and ctx.span_id == "cd" * 8
    assert ptracing.header_value("a" * 32, "b" * 16) == jtracing.header_value("a" * 32, "b" * 16)
    assert len(ptracing.mint_trace_id()) == 32 and len(ptracing.wire_span_id(7)) == 16
    before = ptel.metrics.get_counter("trace_context_invalid_total")
    for raw in ("garbage", "00-" + "0" * 32 + "-" + "1" * 16 + "-01", "00-xyz-abc-01",
                "00-" + "a" * 31 + "-" + "b" * 16 + "-01"):
        assert ptracing.extract(raw) is None and jtracing.extract(raw) is None
    assert ptracing.extract(None) is None
    assert ptel.metrics.get_counter("trace_context_invalid_total") == before + 4


def test_the_chrome_export_validates_under_both_validators(tmp_path):
    rec = ptracing.start_recording()
    try:
        with ptracing.span("rpc.request", method="GET") as sp:
            sp.trace_id = ptracing.mint_trace_id()
            with ptracing.span("extend.device", k=4, blob=b"\x01\x02"):
                pass
        with pytest.raises(ValueError):
            with ptracing.span("node.persist"):
                raise ValueError("disk")
    finally:
        rec.stop()
    assert not ptracing.enabled()
    doc = rec.chrome()
    assert ptracing.validate_chrome_trace(doc) == [] == jtracing.validate_chrome_trace(doc)
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in events] == ["extend.device", "rpc.request", "node.persist"]
    assert events[0]["args"]["parent_id"] == events[1]["args"]["span_id"]
    assert events[1]["args"]["trace_id"] == sp.trace_id
    assert events[1]["args"]["wire_span_id"] == ptracing.wire_span_id(sp)
    assert events[2]["args"]["status"] == "error" and events[0]["args"]["blob"] == "0102"
    path = rec.write(tmp_path / "trace.json")
    assert json.loads(open(path).read()) == json.loads(json.dumps(doc))
    jdoc = jtracing.chrome_trace([])
    assert set(jdoc) == set(doc) and ptracing.validate_chrome_trace(jdoc) == []
    assert ptracing.validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "a", "pid": 1}]}) \
        == jtracing.validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "a", "pid": 1}]})


# ---- the SLO engine


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _renamed(doc):
    return json.loads(json.dumps(doc).replace("tpu_not_sticky_disabled", "gpu_not_sticky_disabled")
                      .replace("extend_tpu_disabled_total", "extend_gpu_disabled_total"))


def test_the_default_objectives_are_the_jax_set_with_the_gpu_rename():
    ours = json.loads(json.dumps([o.__dict__ for o in pslo.default_objectives()]))
    assert ours == _renamed([o.__dict__ for o in jslo.default_objectives()])
    assert [o["name"] for o in ours if "pu_" in o["name"]] == ["gpu_not_sticky_disabled"]
    assert pslo.CROSSOVER_MAX_AGE_S == jslo.CROSSOVER_MAX_AGE_S
    with pytest.raises(ValueError):
        pslo.Objective(name="x", kind="nope")


def _traffic(reg, step: int) -> None:
    """One step of a deterministic traffic script: availability errors in
    steps 2-3, a slow extend tail from step 3, a sticky disable at 4."""
    reg.incr_counter("probe_sample_total", 10)
    reg.incr_counter("probe_sample_ok_total", 10 if step not in (2, 3) else 2)
    reg.incr_counter("rpc_dispatch_total", 20)
    reg.incr_counter("rpc_dispatch_admitted_total", 20 if step != 3 else 5)
    for i in range(4):
        reg.observe("extend_block", 0.01 * (i + 1) if step < 3 else 3.0 + i, backend="gpu")
    if step == 4:
        reg.incr_counter("extend_gpu_disabled_total")
        reg.incr_counter("extend_tpu_disabled_total")
    if step == 5:
        reg.incr_counter("store_read_only_total")


def test_evaluate_and_evaluate_at_judge_like_jax():
    clocks = (FakeClock(), FakeClock())
    regs = (ptel.Registry(), jtel.Registry())
    engines = (pslo.SloEngine(registry=regs[0], clock=clocks[0]),
               jslo.SloEngine(registry=regs[1], clock=clocks[1]))
    captures = ([], [])
    for step in range(7):
        for clock, reg, eng, caps in zip(clocks, regs, engines, captures):
            clock.t = 90.0 * step
            _traffic(reg, step)
            caps.append(eng.capture())
        ours, theirs = (eng.evaluate() for eng in engines)
        assert ours == _renamed(theirs), step
    assert not ours["ok"]
    for a, b in ((0, 2), (1, 4), (3, 6), (0, 6), (5, 5)):
        ours, theirs = (eng.evaluate_at((caps[a], caps[b]))
                        for eng, caps in zip(engines, captures))
        assert ours == _renamed(theirs), (a, b)
    assert regs[0].get_counter("slo_breach_total", objective="sample_availability") == 1.0
    assert regs[0].get_counter("slo_breach_total", objective="gpu_not_sticky_disabled") == 1.0
    node = types.SimpleNamespace(slo=None)
    assert pslo.engine_for(node) is pslo.engine_for(node) is node.slo


# ---- readiness, check by check, on twin nodes


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    tw = Twins(tmp_path_factory.mktemp("slo"), backend="native")
    tw.produce(15.0)
    for raw in (send("alice", 0, 1_000), pfb("bob", 0, [700, 1500], 5)):
        assert tw.broadcast(raw).code == 0
    tw.produce(30.0)
    return tw


def _checks(ready_checks):
    ready, checks = ready_checks
    return ready, json.loads(json.dumps(checks).replace("tpu sticky", "gpu sticky"))


def _both(tw, setup=None):
    out = []
    for node, names in ((tw.port, ("_gpu_disabled", "_gpu_strikes")),
                        (tw.jax, ("_tpu_disabled", "_tpu_strikes"))):
        undo = setup(node, names) if setup else None
        try:
            out.append(_checks((pslo if node is tw.port else jslo).readiness(node)))
        finally:
            if undo:
                undo()
    assert out[0] == out[1], out
    return out[0]


def _attrs(obj, **values):
    old = {k: getattr(obj, k) for k in values}
    for k, v in values.items():
        setattr(obj, k, v)
    return lambda: [setattr(obj, k, v) for k, v in old.items()]


def test_readiness_answers_the_jax_checks(twins):
    ready, checks = _both(twins)
    assert ready and [c["name"] for c in checks] == [
        "not_sticky_degraded", "not_sdc_quarantined", "backend_resolved", "crossover_fresh",
        "arena_not_exhausted", "not_overloaded", "store_writable", "has_blocks"]
    assert {c["name"]: c.get("detail") for c in checks}["crossover_fresh"] == "age_s=0"


@pytest.mark.parametrize("state", ["sticky", "sdc", "stale_crossover", "arena", "backend",
                                   "saturated", "draining", "read_only"])
def test_readiness_flags_each_unfit_state_like_jax(twins, state):
    def setup(node, names):
        app = node.app
        if state == "sticky":
            return _attrs(app, **{names[0]: True, names[1]: 3})
        if state == "sdc":
            return _attrs(app, sdc_quarantined=True,
                          last_sdc={"site": "device.extend.output", "height": 2})
        if state == "stale_crossover":
            return _attrs(app, crossover=types.SimpleNamespace(
                measured_at=time.time() - jslo.CROSSOVER_MAX_AGE_S - 86_400.0))
        if state == "arena":
            return _attrs(app, blob_pool=object(), arena_stats={"assembled": 0, "fallback": 5})
        if state == "backend":
            def boom(_k):
                raise RuntimeError("no backend for k")
            return _attrs(app, resolve_extend_backend=boom)
        if state in ("saturated", "draining"):
            disp = types.SimpleNamespace(saturated=lambda: state == "saturated",
                                         draining=state == "draining", depth=4, capacity=4)
            return _attrs(node, dispatcher=disp)
        return _attrs(node, store=types.SimpleNamespace(read_only=True,
                                                        read_only_reason="ENOSPC"))

    ready, checks = _both(twins, setup)
    bad = [c for c in checks if not c["ok"]]
    assert not ready and len(bad) == 1, checks
    if state == "sticky":
        assert bad[0]["detail"] == "gpu sticky-disabled after 3 strikes"


def test_a_fresh_node_is_not_ready_until_its_first_block(twins):
    from celestia_tpu_torch.app.app import App
    from celestia_tpu_torch.node import Node

    ready, checks = pslo.readiness(Node(App(device="cpu")))
    assert not ready and [c["name"] for c in checks if not c["ok"]] == ["has_blocks"]


# ---- the prober, one cycle at a time


@pytest.fixture(scope="module")
def probed(twins):
    servers = {"jax": JServer(twins.jax, port=0), "port": PServer(twins.port, port=0)}
    for srv in servers.values():
        srv.start()
    try:
        yield {name: f"http://127.0.0.1:{srv.port}" for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()


def _probers(bases, seed: int, **kw):
    regs = {"port": ptel.Registry(), "jax": jtel.Registry()}
    probers = {"port": PProber(bases["port"], rng=random.Random(seed), registry=regs["port"], **kw),
               "jax": JProber(bases["jax"], rng=random.Random(seed), registry=regs["jax"], **kw)}
    return probers, regs


COUNTERS = ("probe_sample_total", "probe_sample_ok_total", "probe_share_proof_total",
            "probe_share_proof_ok_total", "probe_cycle_total", "probe_cycle_ok_total",
            "probe_crosscheck_total", "probe_crosscheck_ok_total")


def test_probe_cycles_match_the_jax_prober(probed):
    probers, regs = _probers(probed, seed=7, samples_per_cycle=5, host_crosscheck=True)
    for _ in range(3):
        ours, theirs = probers["port"].probe_cycle(), probers["jax"].probe_cycle()
        assert ours == theirs and ours["ok"], (ours, theirs)
        assert ours["samples"] == 5 and ours["share_proof_ok"] == 1 and ours["crosscheck_ok"] == 1
    assert [regs["port"].get_counter(c) for c in COUNTERS] == \
        [regs["jax"].get_counter(c) for c in COUNTERS] == [15, 15, 3, 3, 3, 3, 3, 3]
    assert regs["port"].get_gauge("probe_availability_ratio") == 1.0
    assert regs["port"].get_timing("probe_sample").count == 15
    assert probers["port"].last == ours


def test_a_fault_at_the_sample_boundary_breaches_availability(probed):
    """Faults only the /sample fetches (so every failed sample is counted);
    the availability objective breaches on an injected clock, as JAX's."""
    probers, regs = _probers(probed, seed=3, samples_per_cycle=4, share_proofs=False)
    clocks = {name: FakeClock() for name in probers}
    engines = {name: mod.SloEngine([mod.Objective(
        name="sample_availability", kind="ratio", good="probe_sample_ok_total",
        total="probe_sample_total", target=0.999)], registry=regs[name], clock=clocks[name])
        for name, mod in (("port", pslo), ("jax", jslo))}
    verdicts = {}
    for name, fmod in (("port", pfaults), ("jax", jfaults)):
        eng, prober, clock = engines[name], probers[name], clocks[name]
        out = [eng.evaluate()["ok"], prober.probe_cycle()["ok"]]
        clock.t = 10.0
        out.append(eng.evaluate()["ok"])
        with fmod.inject(fmod.rule("probe.request", "error", where="/sample/"), seed=1337):
            out += [prober.probe_cycle()["sample_ok"] for _ in range(3)]
        clock.t = 20.0
        res = eng.evaluate()
        out.append(res["ok"])
        out.append(regs[name].get_counter("slo_breach_total", objective="sample_availability"))
        verdicts[name] = out
    assert verdicts["port"] == verdicts["jax"] == [True, True, True, 0, 0, 0, False, 1.0]


def test_a_post_fault_does_not_touch_the_probers_gets(probed):
    """The prober only reads: a corrupt rule armed at ``rpc.post`` never
    strikes its cycle."""
    probers, _regs = _probers(probed, seed=5, samples_per_cycle=2)
    with pfaults.inject(pfaults.rule("rpc.post", "corrupt"), seed=1) as inj:
        assert probers["port"].probe_cycle()["ok"]
    assert inj.schedule == []


def test_an_unreachable_node_fails_the_cycle():
    reg = ptel.Registry()
    summary = PProber("http://127.0.0.1:1", registry=reg, timeout=0.5,
                      rng=random.Random(0)).probe_cycle()
    assert not summary["ok"] and summary["error"].startswith("status:")
    assert reg.get_counter("probe_cycle_total") == 1.0


# ---- the cadence, on an injected clock


def test_next_slot_counts_overruns_and_skips_missed_slots():
    clock = FakeClock(0.0)
    reg = ptel.Registry()
    prober = PProber("http://127.0.0.1:1", interval=1.0, registry=reg, clock=clock)
    clock.t = 0.4
    assert prober._next_slot(0.0) == 1.0 and reg.get_counter("probe_overrun_total") == 0
    clock.t = 3.5  # a cycle ran past slots 1, 2 and 3
    assert prober._next_slot(0.0) == 4.0 and reg.get_counter("probe_overrun_total") == 1
    clock.t = 4.0  # exactly on the next slot: an overrun, the slot skipped
    assert prober._next_slot(3.0) == 5.0 and reg.get_counter("probe_overrun_total") == 2


def test_the_thread_keeps_an_absolute_grid_on_a_stepped_clock():
    """The loop's waits come from the grid, not from the cycle's length: a
    stepped clock and a recording wait stand in for time."""
    clock = FakeClock(100.0)
    waits = []
    done = threading.Event()
    reg = ptel.Registry()
    durations = iter([0.2, 0.1, 2.5, 0.3, 0.0])

    def wait(seconds: float) -> bool:
        waits.append(round(seconds, 6))
        clock.t += seconds
        if len(waits) == 5:
            prober._stop.set()
            done.set()
        return prober._stop.is_set()

    prober = PProber("http://127.0.0.1:1", interval=1.0, registry=reg, clock=clock, wait=wait)

    def cycle():
        clock.t += next(durations)
        return {"ok": True}

    prober.probe_cycle = cycle
    prober.start()
    assert done.wait(30)
    prober.stop()
    assert waits == [0.8, 0.9, 0.5, 0.7, 1.0]
    assert reg.get_counter("probe_overrun_total") == 1.0
    assert prober._thread is None
