"""The port's scenario engine (``celestia_tpu_torch/scenarios/``) against the
JAX package's, on the CPU.

The schema refuses what the JAX schema refuses, with the same message; its
strike actions are ``gpu_strike``/``gpu_recover`` where the JAX package says
``tpu_*`` (each package refuses the other's names). The ten shipped suites
equal JAX's field by field once those renames and the disable objective's
(``gpu_not_sticky_disabled`` for ``tpu_not_sticky_disabled``) are read back.
``campaign_rules``, the verdict contract, the open-load meter and the knee
detector give JAX's answers on the same inputs; the scenario and soak ledger
folds are read by the JAX package's ``tools/perf_ledger``. The world takes
``device=None`` to mean CUDA and raises on this host without a GPU; on
``device="cpu"`` its audited production degrades only on
``DeviceUnavailable`` (a host-fallback block) and ``IntegrityError`` (a
quarantine), and anything else propagates. Last, the ``smoke`` suite end to
end: one run of the port and one of the JAX package on one seed, each at
three times the suite's durations (the port's plain-PyTorch extend on the CPU is
slower than XLA's), give the same fault timeline and the same verdict.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest

from celestia_tpu import scenarios as jsc
from celestia_tpu.scenarios import engine as jengine
from celestia_tpu.scenarios import openload as jopen
from celestia_tpu.scenarios import verdict as jverdict
from celestia_tpu_torch import faults, integrity
from celestia_tpu_torch import scenarios as psc
from celestia_tpu_torch.scenarios import engine as pengine
from celestia_tpu_torch.scenarios import openload as popen
from celestia_tpu_torch.scenarios import verdict as pverdict
from celestia_tpu_torch.scenarios import world as pworld
from celestia_tpu_torch.telemetry import Registry

RENAMES = {"tpu_strike": "gpu_strike", "tpu_recover": "gpu_recover",
           "tpu_not_sticky_disabled": "gpu_not_sticky_disabled"}


def _ported(value):
    """A JAX scenario value with the port's names."""
    if isinstance(value, str):
        for old, new in RENAMES.items():
            value = value.replace(old, new)
        return value
    if isinstance(value, dict):
        return {k: _ported(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_ported(v) for v in value)
    if isinstance(value, frozenset):
        return frozenset(_ported(v) for v in value)
    return value


def test_the_schema_constants_are_jaxs_with_the_renames():
    assert psc.ACTIONS == _ported(jsc.ACTIONS)
    assert "gpu_strike" in psc.ACTIONS and "tpu_strike" not in psc.ACTIONS
    assert psc.INVARIANTS == jsc.INVARIANTS and psc.LOAD_KINDS == jsc.LOAD_KINDS
    assert psc.SDC_SITES == jsc.SDC_SITES
    assert "probability" not in {f.name for f in dataclasses.fields(psc.CampaignRule)}


def _phase(mod, **kw):
    kw.setdefault("name", "p")
    kw.setdefault("duration_s", 0.1)
    return mod.Phase(**kw)


def _scenario(mod, **kw):
    kw.setdefault("name", "s")
    kw.setdefault("description", "d")
    kw.setdefault("phases", (_phase(mod),))
    return mod.Scenario(**kw)


INVALID = {
    "load_kind": lambda m: m.LoadSpec(kind="ddos"),
    "pfb_profile": lambda m: m.LoadSpec(kind="pfb"),
    "open_das_rate": lambda m: m.LoadSpec(kind="open_das", clients=1),
    "action": lambda m: _phase(m, enter_actions=("reboot",)),
    "exit_action": lambda m: _phase(m, exit_actions=("reboot",)),
    "invariant": lambda m: _scenario(m, invariants=("vibes",)),
    "duplicate_phase": lambda m: _scenario(m, phases=(_phase(m), _phase(m))),
    "no_phase": lambda m: _scenario(m, phases=()),
    "follower_boot": lambda m: _scenario(m, phases=(
        _phase(m, loads=(m.LoadSpec(kind="follower_sync"),)),)),
    "restart_fleet": lambda m: _scenario(m, phases=(
        _phase(m, enter_actions=("backend_restart",)),)),
    "restart_invariant": lambda m: _scenario(m, fleet=1,
                                             invariants=("restarted_serves_from_store",)),
    "fleet_sdc": lambda m: _scenario(m, fleet=2, sdc_producer=True),
    "fleet_modes": lambda m: _scenario(m, fleet=2, fleet_processes=2),
    "process_sdc": lambda m: _scenario(m, fleet_processes=2, sdc_producer=True),
    "process_pfb": lambda m: _scenario(m, fleet_processes=2, phases=(
        _phase(m, loads=(m.LoadSpec(kind="pfb", profile="huge-rollup"),)),)),
    "scale_out": lambda m: _scenario(m, fleet_processes=1, phases=(
        _phase(m, enter_actions=("fleet_scale_out",)),)),
    "scaled_invariant": lambda m: _scenario(m, invariants=("fleet_scaled_out",)),
    "store_fleet": lambda m: _scenario(m, store=True, fleet=3),
    "compact_store": lambda m: _scenario(m, store_compact_budget_bytes=1 << 20),
    "retain_store": lambda m: _scenario(m, retain_heights=10),
    "disk_pressure": lambda m: _scenario(m, phases=(
        _phase(m, enter_actions=("disk_pressure_on",)),)),
    "writable_invariant": lambda m: _scenario(m, invariants=("store_recovered_writable",)),
    "byte_identity": lambda m: _scenario(m, invariants=("soak_byte_identity",)),
    "drift": lambda m: _scenario(m, invariants=("no_monotone_drift",)),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_the_schema_refuses_what_jax_refuses(case):
    with pytest.raises(ValueError) as perr:
        INVALID[case](psc)
    with pytest.raises(ValueError) as jerr:
        INVALID[case](jsc)
    assert str(perr.value) == _ported(str(jerr.value))


@pytest.mark.parametrize("ours,theirs", [("gpu_strike", "tpu_strike"),
                                         ("gpu_recover", "tpu_recover")])
def test_each_package_refuses_the_others_strike_names(ours, theirs):
    assert _phase(psc, enter_actions=(ours,)).enter_actions == (ours,)
    with pytest.raises(ValueError, match="unknown action"):
        _phase(psc, enter_actions=(theirs,))
    with pytest.raises(ValueError, match="unknown action"):
        _phase(jsc, enter_actions=(ours,))


@pytest.mark.parametrize("name", sorted(jsc.SCENARIOS))
def test_the_library_is_jaxs_field_by_field(name):
    port, jax = psc.get(name), jsc.get(name)
    assert dataclasses.asdict(port) == _ported(dataclasses.asdict(jax))
    rules = [(r.site, r.kind, r.times, r.after, r.delay_s, r.where, r.phase, r.probability)
             for r in pengine.campaign_rules(port)]
    assert rules == [(r.site, r.kind, r.times, r.after, r.delay_s, r.where, r.phase,
                      r.probability) for r in jengine.campaign_rules(jax)]
    assert all(r[-1] == 1.0 for r in rules)


def test_the_renamed_suites_name_the_ports_objective():
    from celestia_tpu_torch.slo import SloEngine

    names = {o.name for o in SloEngine(registry=Registry()).objectives}
    for name in ("rolling-outage", "smoke"):
        sc = psc.get(name)
        assert "gpu_not_sticky_disabled" in sc.required_breaches <= names | {"sdc_detected"}
        actions = {a for ph in sc.phases for a in ph.enter_actions + ph.exit_actions}
        assert {"gpu_strike", "gpu_recover"} <= actions
    with pytest.raises(KeyError, match="pfb-storm"):
        psc.get("nope")


def _whole(failing=()):
    return {"ok": not failing, "window_s": 1.0,
            "objectives": [{"name": n, "ok": n not in failing} for n in ("a", "b", "c")]}


VERDICTS = {
    "clean": ({}, (), []),
    "unexpected": ({}, ("a",), []),
    "allowed": ({"allowed_breaches": frozenset({"a"})}, ("a",), []),
    "missing_required": ({"required_breaches": frozenset({"a"})}, (), []),
    "required_present": ({"required_breaches": frozenset({"a"})}, ("a",), []),
    "failed_invariant": ({}, (), [{"name": "dah_byte_identical", "ok": False, "detail": "x"}]),
    "everything": ({"required_breaches": frozenset({"c"})}, ("a", "b"),
                   [{"name": "prober_verified", "ok": False, "detail": "y"},
                    {"name": "readyz_well_ordered", "ok": True, "detail": "z"}]),
}


@pytest.mark.parametrize("case", sorted(VERDICTS))
def test_the_verdict_contract_is_jaxs(case):
    kw, failing, invariants = VERDICTS[case]
    phases = [{"slo": {"ok": True}}, {"slo": {"ok": not failing}}]
    got = pverdict.assemble(_scenario(psc, **kw), _whole(failing), phases, {"ok": True},
                            invariants)
    assert got == jverdict.assemble(_scenario(jsc, **kw), _whole(failing), phases,
                                    {"ok": True}, invariants)
    assert got["pass"] == (case in ("clean", "allowed", "required_present"))


def _meter(mod):
    m = mod.OpenLoadMeter()
    m.begin_phase("big", 100.0, now=0.0)
    for lat in (0.01, 0.02, 0.5):
        m.note_offered()
        m.note(lat, ok=lat < 0.4)
    m.begin_phase("idle", 0.0, now=1.0)
    m.begin_phase("small", 10.0, now=2.0)
    for _ in range(10):
        m.note_offered()
    for lat in (0.1, 0.2, 0.3):
        m.note(lat, ok=True)
    m.end(now=3.0)
    m.note(9.0, ok=True)  # after end: dropped
    return m.curve()


def test_the_open_load_meter_is_jaxs():
    curve = _meter(popen)
    assert curve == _meter(jopen)
    assert [s["phase"] for s in curve] == ["small", "big"]
    assert curve[0]["offered"] == 10 and curve[0]["goodput_hz"] == 3.0


def _step(hz, goodput=None, p99=0.01):
    return {"phase": f"s{hz}", "planned_hz": float(hz), "offered_hz": float(hz),
            "goodput_hz": float(goodput if goodput is not None else hz), "p99_s": p99}


KNEES = {
    "healthy": [_step(10), _step(50), _step(100)],
    "collapse": [_step(10), _step(50), _step(100, goodput=60.0)],
    "p99_blowup": [_step(10, p99=0.01), _step(50, p99=0.02), _step(100, p99=0.5)],
    "first_step": [_step(10, goodput=1.0), _step(50)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(KNEES))
def test_the_knee_is_jaxs(case):
    assert popen.detect_knee(KNEES[case]) == jopen.detect_knee(KNEES[case])
    assert popen.detect_knee(KNEES[case], goodput_floor=0.5, p99_blowup=100.0) == \
        jopen.detect_knee(KNEES[case], goodput_floor=0.5, p99_blowup=100.0)


def _report(breaches=0, drift=0, knee_hz=None):
    rep = {"scenario": "smoke", "seed": 1, "scenario_slo_pass": breaches == 0,
           "breaches": breaches, "wall_s": 5.0,
           "drift": [{"series": f"s{i}", "drifting": i < drift} for i in range(4)]}
    if knee_hz is not None:
        rep["load_curve"] = {"steps": [], "knee": {"found": False, "knee_hz": knee_hz}}
    return rep


def test_the_scenario_ledger_folds_for_jaxs_perf_ledger(tmp_path):
    from celestia_tpu.tools import perf_ledger

    path = str(tmp_path / "scenario_ledger.json")
    (tmp_path / "scenario_ledger.json").write_text("not json{")  # replaced
    for b in (0, 0, 0, 2):
        psc.append_ledger(path, _report(breaches=b))
    led = perf_ledger.load_ledger(str(tmp_path))
    series = led["scenario_slo_pass"]
    assert [v for _l, v in series] == [0.0, 0.0, 0.0, 2.0]
    assert perf_ledger.judge(series, perf_ledger.DEFAULT_THRESHOLD,
                             perf_ledger.DEFAULT_MIN_HISTORY)["regressed"]
    for i in range(70):
        psc.append_ledger(path, _report(breaches=i % 2))
    runs = json.loads((tmp_path / "scenario_ledger.json").read_text())["runs"]
    assert len(runs) == pengine.LEDGER_MAX_RUNS == jengine.LEDGER_MAX_RUNS
    assert set(runs[-1]) == {"ts", "scenario", "seed", "pass", "breaches", "wall_s"}


def test_the_soak_ledger_folds_for_jaxs_perf_ledger(tmp_path):
    from celestia_tpu.tools import perf_ledger

    path = str(tmp_path / "soak_ledger.json")
    for drift, knee in ((0, 200.0), (0, 210.0), (0, 190.0), (2, 50.0)):
        rep = _report(drift=drift, knee_hz=knee)
        rep["provenance"] = {"host": "h"}
        pengine.append_soak_ledger(path, rep)
    led = perf_ledger.load_ledger(str(tmp_path))
    assert [v for _l, v in led["soak_drift_breaches"]] == [0.0, 0.0, 0.0, 2.0]
    assert [v for _l, v in led["soak_knee_samples_per_sec"]] == [200.0, 210.0, 190.0, 50.0]
    assert perf_ledger.judge(led["soak_knee_samples_per_sec"], perf_ledger.DEFAULT_THRESHOLD,
                             perf_ledger.DEFAULT_MIN_HISTORY,
                             higher_is_better=True)["regressed"]


def test_the_world_and_the_engine_raise_without_a_gpu():
    sc = psc.get("smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pworld.ScenarioWorld(sc, seed=1, registry=Registry())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psc.run_scenario(sc, seed=1, registry=Registry())


def test_the_cli_lists_the_suites_and_takes_a_device(capsys):
    from celestia_tpu_torch.scenarios import __main__ as cli

    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == sorted(jsc.SCENARIOS)
    with pytest.raises(SystemExit):
        cli.main(["smoke", "--san"])  # waits for the sanitizer's port
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["smoke"])  # --device cuda by default


def _world(**kw):
    sc = _scenario(psc, k=2, sdc_producer=True, **kw)
    return pworld.ScenarioWorld(sc, seed=5, registry=Registry(), device="cpu")


def test_a_strike_sets_the_ports_names_and_counts_the_disable():
    w = _world()
    w.apply_actions(("gpu_strike",))
    app = w.node.app
    assert (app._gpu_strikes, app._gpu_disabled, app.extend_backend) == (3, True, "gpu")
    assert w.registry.get_counter("extend_gpu_disabled_total") == 1.0
    assert w.degradations[-1]["kind"] == "gpu_strike" and w.degradations[-1]["t1"] is None
    w.apply_actions(("gpu_recover",))
    assert (app._gpu_strikes, app._gpu_disabled) == (0, False)
    assert w.degradations[-1]["t1"] is not None


def test_audited_production_commits_the_host_dah_on_every_path(monkeypatch):
    from celestia_tpu_torch.ops import extend
    from celestia_tpu_torch.testutil.chaosnet import extend_chain

    w = _world()
    integrity.configure("full")
    try:
        assert w.produce_block() == 2  # clean: the device's DAH is the host's
        with faults.inject(faults.rule("device.extend", "unavailable", times=1)):
            assert w.produce_block() == 3
        with faults.inject(faults.rule("device.extend.output", "bitflip", times=1), seed=4):
            assert w.produce_block() == 4
        with faults.inject(faults.rule("transfer.chunk", "bitflip", times=2,
                                       where="scenario.stage"), seed=4):
            assert w.produce_block() == 5
    finally:
        integrity.configure("off")
    assert w.produced == {"blocks": 4, "device_blocks": 1, "host_fallback_blocks": 3}
    assert [d["height"] for d in w.sdc_detections] == [4, 5] and not w.sdc_missed
    # the chunk check's error names no site, in the JAX package too
    assert [d["site"] for d in w.sdc_detections] == ["device.extend.output", "unknown"]
    assert all(d["host_dah"] == d["reference_dah"] for d in w.sdc_detections)
    assert w.node.app.sdc_quarantined and w.node.app.sdc_events == 2
    for h in (2, 3, 4, 5):
        assert w.node.block_dah(h).hash() == extend_chain(2, h, 5)[1].hash()

    def broken(*_args, **_kw):
        raise RuntimeError("a bug, not a device fault")

    monkeypatch.setattr(extend, "extend_roots_device", broken)
    with pytest.raises(RuntimeError, match="a bug"):
        w.produce_block()
    assert 6 not in w.node.blocks


def test_the_open_das_driver_charges_the_backlog_to_latency(monkeypatch):
    sc = _scenario(psc, k=2, initial_heights=5, phases=(_phase(
        psc, loads=(psc.LoadSpec(kind="open_das", clients=1, rate_hz=100.0),)),))
    w = pworld.ScenarioWorld(sc, seed=3, registry=Registry(), device="cpu")
    w.url = "http://unused.invalid"

    def slow_fetch(_base, _path, timeout=5.0):
        time.sleep(0.04)
        return 200, b""

    monkeypatch.setattr(pworld, "_fetch", slow_fetch)
    w.openload.begin_phase("p", 100.0, now=time.monotonic())
    stop = threading.Event()
    t = threading.Thread(target=w._open_das_client, args=(sc.phases[0].loads[0], 7, stop),
                         daemon=True)
    t.start()
    time.sleep(0.6)
    stop.set()
    t.join(timeout=2.0)
    assert not t.is_alive()
    w.openload.end(now=time.monotonic())
    (step,) = w.openload.curve()
    assert step["offered"] > 2 * step["done"] and step["done"] >= 5
    assert step["p90_s"] > 0.12


def test_the_verdicts_dah_probe_recomputes_on_the_host():
    w = _world(initial_heights=3)
    probe = pverdict._probe_dah_byte_identical
    assert probe(w.scenario, w, None, None, None, None) == (True, "3 heights byte-identical")
    eds, dah = w.node.blocks[2]
    w.node.blocks[2] = (eds, type(dah)(dah.row_roots[::-1], dah.column_roots))
    assert probe(w.scenario, w, None, None, None, None)[0] is False


SMOKE_SEED = 424242


def _verdict(report):
    v = dict(report["verdict"])
    v.pop("phase_slo_ok")  # which phase's window holds a breach depends on timing
    v["breaching_objectives"] = sorted(_ported(v["breaching_objectives"]))
    return v


def test_smoke_end_to_end_gives_the_jax_timeline_and_verdict():
    # each package's process registry: the SDC audit counts there
    port = psc.run_scenario(psc.get("smoke"), seed=SMOKE_SEED, duration_scale=3.0,
                            device="cpu")
    jax = jsc.run_scenario(jsc.get("smoke"), seed=SMOKE_SEED, duration_scale=3.0)
    assert jax["scenario_slo_pass"], jax["verdict"]
    assert port["scenario_slo_pass"], (port["verdict"], port["invariants"])
    assert port["fault_timeline"] == jax["fault_timeline"]
    assert len(port["fault_timeline"]) == 9
    assert _verdict(port) == _verdict(jax)
    assert port["world"]["produced"]["device_blocks"] > 0
    assert not port["world"]["sdc_missed"]
    assert [i["name"] for i in port["invariants"]] == [i["name"] for i in jax["invariants"]]
    assert np.all([i["ok"] for i in port["invariants"]])
