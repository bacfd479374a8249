"""Scenario engine: run a declarative Scenario, judge it by the SLO board
(port of the JAX package's scenarios/engine.py).

The run loop (specs/scenarios.md):

    arm ONE seeded FaultInjector carrying every campaign rule,
    phase-scoped so each rule is dormant outside its phase;
    for each phase:
        set the injector phase label, apply enter actions,
        bracket the phase with SloEngine.capture(),
        start the phase's load drivers, drive prober cycles and
        periodic SLO evaluations until the (scaled) deadline,
        stop drivers, apply exit actions, clear the phase label,
        record the phase report (loads, windowed SLO verdict, the
        slice of the fault timeline the phase produced);
    quiesce, take the whole-run SLO window, run the invariant
    probes, assemble the verdict, emit the machine-readable report.

The oracle is the node's own SLO engine plus the invariant probes —
no bespoke asserts: a scenario passes when the breaching-objective set
matches its contract (allowed/required) and every invariant holds.
"""

from __future__ import annotations

import json
import os
import threading
import time

from celestia_tpu_torch import devledger, faults, slo

from . import verdict as verdict_mod
from .spec import Scenario
from .world import ScenarioWorld

#: ledger cap — matches storm_ledger.json's bounded-history approach
LEDGER_MAX_RUNS = 64


def campaign_rules(scenario: Scenario) -> list[faults.FaultRule]:
    """Every phase's campaigns as phase-scoped injector rules. Count-
    gated by construction (CampaignRule has no probability field), so
    the resulting site-local timeline is the reproducibility artifact."""
    rules = []
    for ph in scenario.phases:
        for c in ph.campaigns:
            rules.append(faults.rule(
                c.site, c.kind, times=c.times, after=c.after,
                delay_s=c.delay_s, where=c.where, phase=ph.name,
            ))
    return rules


def run_scenario(scenario: Scenario, *, seed: int = 1337,
                 duration_scale: float = 1.0,
                 report_path: str | None = None,
                 ledger_path: str | None = None,
                 record_path: str | None = None,
                 soak_ledger_path: str | None = None,
                 inject_leak: bool = False,
                 inject_retrace: bool = False,
                 registry=None, device=None) -> dict:
    """Execute one scenario end to end; returns the scenario report.

    ``record_path`` (or a scenario with ``record_cadence_s > 0``)
    starts a tsdb Scraper for the run's whole life and judges drift /
    the recorded-SLO replay from the resulting ``.ctts``.
    ``inject_leak`` runs a synthetic monotone-gauge leak
    (``soak_leak_bytes``) that the drift verdict MUST flag — the
    red-path self-test of the no_monotone_drift invariant.
    ``inject_retrace`` churns synthetic post-warmup shape keys on a
    known instrumented builder — the `zero_steadystate_retraces` invariant
    MUST flag it (the build watchdog's red-path self-test). ``device``
    is the world's (None means CUDA: raises without a GPU unless the
    caller passes ``"cpu"``)."""
    if registry is None:
        from celestia_tpu_torch.telemetry import metrics as registry
    if getattr(scenario, "fleet_processes", 0):
        from .fleet import FleetProcessWorld

        world = FleetProcessWorld(scenario, seed, registry=registry,
                                  device=device)
    elif getattr(scenario, "fleet", 0):
        from .fleet import FleetWorld

        world = FleetWorld(scenario, seed, registry=registry, device=device)
    else:
        world = ScenarioWorld(scenario, seed, registry=registry,
                              device=device)
    world.duration_scale = duration_scale
    injector = faults.FaultInjector(campaign_rules(scenario), seed=seed)
    engine = slo.SloEngine(registry=registry)
    phases: list[dict] = []
    recording_meta: dict | None = None
    t_start = time.monotonic()
    with faults.inject(injector=injector):
        # compile-watchdog warmup bracket: everything up to the END of
        # the first phase (world warm-produce included) may trace new
        # shapes freely; from then on a new key on a known entry is a
        # steady-state retrace the verdict judges
        devledger.begin_warmup()
        world.start()
        scraper, rec_path, rec_tmp = _start_recording(
            scenario, world, registry, record_path, seed)
        leak_stop = _start_leak(registry) if inject_leak else None
        churn_stop = _start_retrace_churn() if inject_retrace else None
        run_cap0 = engine.capture()
        for i, ph in enumerate(scenario.phases):
            phases.append(_run_phase(scenario, ph, world, injector,
                                     engine, seed, duration_scale))
            if i == 0:
                devledger.end_warmup()
        world.openload.end(time.monotonic())
        world.quiesce()
        world.freeze()  # heights stable: probes judge a fixed chain
        world.settle_follower()
        if leak_stop is not None:
            leak_stop.set()
        if churn_stop is not None:
            churn_stop.set()
        steadystate_retraces = devledger.ledger.retrace_count()
        recording_meta = _finish_recording(scenario, world, engine,
                                           scraper, rec_path,
                                           inject_leak)
        run_cap1 = engine.capture()
        whole_run = engine.evaluate_at((run_cap0, run_cap1))
        final = engine.evaluate()  # breach transitions on full history
        invariants = verdict_mod.run_invariants(scenario, world, injector,
                                                registry, run_cap0, run_cap1)
        world.stop()
        if rec_tmp is not None:
            rec_tmp.cleanup()
    v = verdict_mod.assemble(scenario, whole_run, phases, final, invariants)
    report = {
        "scenario": scenario.name,
        "description": scenario.description,
        "seed": seed,
        "duration_scale": duration_scale,
        "wall_s": round(time.monotonic() - t_start, 3),
        # host/runtime identity: longitudinal soak series are only
        # comparable within one fingerprint (ADR-011)
        "provenance": devledger.runtime_provenance(),
        # post-warmup rebuilds of known instrumented builders — folded into
        # the perf ledger as a lower-is-better series
        "steadystate_retraces": steadystate_retraces,
        "phases": phases,
        "slo": {"whole_run": whole_run, "final_ok": final["ok"]},
        "invariants": invariants,
        "fault_timeline": [list(e) for e in injector.site_timeline],
        "world": {
            "heights": world.node.latest_height(),
            "produced": dict(world.produced),
            "mempool": dict(world.node.mempool_stats),
            "das": dict(world.das_stats),
            "pfb": dict(world.pfb_stats),
            "sdc_detections": list(world.sdc_detections),
            "sdc_missed": list(world.sdc_missed),
            "follower": dict(world.follower_stats),
            "readyz_transitions": [
                [round(t - t_start, 3), ready, list(failing)]
                for t, ready, failing in world.readyz_transitions()
            ],
        },
        "verdict": v,
        "scenario_slo_pass": v["pass"],
        "breaches": v["breaches"],
    }
    if hasattr(world, "fleet_report"):
        report["world"]["fleet"] = world.fleet_report()
    curve = world.openload.curve()
    if curve:
        from .openload import detect_knee

        report["load_curve"] = {"steps": curve,
                                "knee": detect_knee(curve)}
    if recording_meta is not None:
        report["recording"] = recording_meta
        report["drift"] = world.drift_report
        if "slo_recorded" in recording_meta:
            report["slo"]["recorded"] = recording_meta.pop("slo_recorded")
    if soak_ledger_path:
        append_soak_ledger(soak_ledger_path, report)
    if report_path:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
    if ledger_path:
        append_ledger(ledger_path, report)
    return report


def _start_recording(scenario: Scenario, world, registry,
                     record_path: str | None, seed: int):
    """Boot the longitudinal recorder when the scenario (or caller)
    asks for one. Returns (scraper, path, tempdir|None) or a None
    triple. The global-registry world is scraped over HTTP — the real
    /metrics wire — while an isolated-registry run (tests) renders its
    own registry through the identical parse path."""
    if not (record_path or scenario.record_cadence_s > 0):
        return None, None, None
    from celestia_tpu_torch import telemetry
    from celestia_tpu_torch.tools import tsdb

    rec_tmp = None
    path = record_path
    if path is None:
        import tempfile

        rec_tmp = tempfile.TemporaryDirectory(prefix="ctts-")
        path = os.path.join(rec_tmp.name, f"{scenario.name}.ctts")
    cadence = scenario.record_cadence_s or tsdb.DEFAULT_CADENCE_S
    meta = {"scenario": scenario.name, "seed": seed,
            "provenance": devledger.runtime_provenance()}
    if registry is telemetry.metrics and getattr(world, "url", None):
        scraper = tsdb.Scraper(world.url + "/metrics", path,
                               cadence_s=cadence, meta=meta)
    else:
        scraper = tsdb.RegistryScraper(registry, path, cadence_s=cadence,
                                       meta=meta)
    scraper.start()
    return scraper, path, rec_tmp


def _start_leak(registry) -> threading.Event:
    """Synthetic leak: a gauge that only ever goes up. The drift
    detector MUST flag it — the red-path self-test proving the
    no_monotone_drift verdict can actually fail."""
    stop = threading.Event()

    def _leak():
        total = 0.0
        while not stop.is_set():
            total += 1_048_576.0
            registry.set_gauge("soak_leak_bytes", total)
            stop.wait(0.1)

    threading.Thread(target=_leak, daemon=True, name="soak-leak").start()
    return stop


def _start_retrace_churn() -> threading.Event:
    """Synthetic steady-state geometry churn: a known builder entry
    keeps seeing NEW shape keys after warmup ends. The
    `zero_steadystate_retraces` invariant MUST flag it — the red-path
    self-test proving the compile watchdog can actually fail a run."""
    stop = threading.Event()
    ledger = devledger.ledger
    # make the entry KNOWN while still in warmup, so the churned keys
    # below are judged as retraces, not first compiles
    ledger.note_build("scenario.churn", "(warmup)")

    def _churn():
        n = 0
        while not stop.is_set():
            if ledger.warm:
                n += 1
                try:
                    ledger.note_build("scenario.churn", f"(churn-{n})")
                except devledger.RetraceError:
                    pass  # strict mode in the embedding process
            stop.wait(0.1)

    threading.Thread(target=_churn, daemon=True,
                     name="retrace-churn").start()
    return stop


def _finish_recording(scenario: Scenario, world, engine, scraper,
                      rec_path: str | None,
                      inject_leak: bool) -> dict | None:
    """Stop the scraper, read the .ctts back, drift-judge the
    configured series (plus the injected leak gauge), and replay the
    whole-run SLO window from the RECORDING — durable data, not live
    snapshots."""
    if scraper is None:
        return None
    from celestia_tpu_torch.tools import tsdb

    scraper.stop(final_scrape=True)
    meta = {
        "path": rec_path,
        "cadence_s": scraper.cadence_s,
        "scrapes": scraper.scrapes,
        "scrape_errors": scraper.scrape_errors,
        "overruns": scraper.overruns,
        "counter_resets": sum(scraper.reset_counts.values()),
    }
    try:
        rec = tsdb.read(rec_path)
    except Exception as e:  # noqa: BLE001 — a bad recording is reported
        meta["read_error"] = str(e)
        world.drift_report = None
        return meta
    meta["samples"] = len(rec.samples)
    meta["series"] = len(rec.names)
    specs = tuple(scenario.drift_series)
    if inject_leak and "soak_leak_bytes" not in specs:
        specs += ("soak_leak_bytes",)
    if specs:
        world.drift_report = tsdb.analyze_drift(rec, specs)
    if len(rec.samples) >= 2:
        meta["slo_recorded"] = engine.evaluate_at(
            (rec.capture_at(engine.objectives, rec.t0),
             rec.capture_at(engine.objectives, rec.t1)))
    return meta


def append_soak_ledger(path: str, report: dict) -> None:
    """Fold one recorded run into soak_ledger.json (`make bench-gate`
    reads ``drift_breaches`` — 0 means no series drifted — and the
    knee goodput when a sweep emitted a load curve)."""
    doc: dict = {"runs": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and isinstance(
                    loaded.get("runs"), list):
                doc = loaded
        except (OSError, ValueError):
            pass
    drift = report.get("drift") or []
    knee = (report.get("load_curve") or {}).get("knee") or {}
    doc["runs"].append({
        "ts": time.time(),
        "scenario": report["scenario"],
        "seed": report["seed"],
        "pass": report["scenario_slo_pass"],
        "drift_breaches": sum(1 for d in drift if d.get("drifting")),
        "knee_samples_per_sec": knee.get("knee_hz"),
        "steadystate_retraces": report.get("steadystate_retraces", 0),
        "provenance": report.get("provenance"),
        "wall_s": report["wall_s"],
    })
    doc["runs"] = doc["runs"][-LEDGER_MAX_RUNS:]
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)


def _run_phase(scenario: Scenario, ph, world: ScenarioWorld,
               injector: faults.FaultInjector, engine: slo.SloEngine,
               seed: int, duration_scale: float) -> dict:
    injector.set_phase(ph.name)
    world.apply_actions(ph.enter_actions)
    open_hz = sum(ls.clients * (ls.rate_hz or 0.0)
                  for ls in ph.loads if ls.kind == "open_das")
    if open_hz:
        world.openload.begin_phase(ph.name, open_hz, time.monotonic())
    else:
        world.openload.end(time.monotonic())
    overload = any(c.site.startswith("dispatch.") for c in ph.campaigns)
    if overload:
        # a dispatcher campaign may legitimately flip /readyz's
        # not_overloaded check — declare the window so the readiness
        # invariant can tell expected flips from spurious ones
        world.note_degradation("overload")
    cap0 = engine.capture()
    timeline_mark = len(injector.site_timeline)
    stop = threading.Event()
    drivers = world.start_loads(ph.loads, seed, stop)
    deadline = time.monotonic() + ph.duration_s * duration_scale
    next_probe = 0.0
    next_eval = 0.0
    while time.monotonic() < deadline:
        now = time.monotonic()
        if world.prober is not None and now >= next_probe:
            try:
                world.prober.probe_cycle()
            except Exception:  # noqa: BLE001 — probes must not kill a run
                pass
            next_probe = now + 0.35
        if now >= next_eval:
            engine.evaluate()  # feed the burn-rate snapshot history
            next_eval = now + 0.5
        time.sleep(0.03)
    stop.set()
    for t in drivers:
        t.join(timeout=10)
    world.apply_actions(ph.exit_actions)
    if overload:
        world.end_degradation("overload")
    injector.set_phase(None)
    cap1 = engine.capture()
    return {
        "name": ph.name,
        "duration_s": ph.duration_s * duration_scale,
        "loads": [
            {"kind": ls.kind, "clients": ls.clients, "profile": ls.profile,
             "rate_hz": ls.rate_hz}
            for ls in ph.loads
        ],
        "slo": engine.evaluate_at((cap0, cap1)),
        "faults": [list(e) for e in
                   injector.site_timeline[timeline_mark:]],
    }


def append_ledger(path: str, report: dict) -> None:
    """Fold one run into the scenario ledger (`make bench-gate` reads
    the ``breaches`` series as ``scenario_slo_pass``: 0 = every SLO and
    invariant held, >0 = the run breached its contract)."""
    doc: dict = {"runs": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and isinstance(
                    loaded.get("runs"), list):
                doc = loaded
        except (OSError, ValueError):
            pass
    doc["runs"].append({
        "ts": time.time(),
        "scenario": report["scenario"],
        "seed": report["seed"],
        "pass": report["scenario_slo_pass"],
        "breaches": report["breaches"],
        "wall_s": report["wall_s"],
    })
    doc["runs"] = doc["runs"][-LEDGER_MAX_RUNS:]
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
