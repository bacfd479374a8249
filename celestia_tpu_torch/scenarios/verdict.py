"""Teardown verdict: SLO contract matching + invariant probes (port of
the JAX package's scenarios/verdict.py; the strike window is ``gpu_strike``).

The verdict has two layers (specs/scenarios.md):

    SLO contract — the whole-run windowed evaluation's breaching-
    objective set must be a subset of ``allowed_breaches`` and a
    superset of ``required_breaches``. Required breaches make
    DETECTION itself an acceptance criterion: sdc-under-storm fails
    unless ``sdc_detected`` breached, because corruption that never
    surfaced on the SLO board is worse than corruption that did.

    Invariant probes — properties that must hold regardless of SLO
    arithmetic: every prober-accepted sample was NMT-verified, the
    served DAH is byte-identical to an independent host recompute at
    every height (across every degradation), /readyz flips are
    well-ordered against the world's declared degradation windows, no
    injected SDC went undetected, and a rejoining follower converged
    on byte-identical state.
"""

from __future__ import annotations

from .spec import SDC_SITES, Scenario

#: slack around degradation windows when judging readiness flips —
#: the watcher samples at 150 ms and dispatch queues drain asynchronously
READYZ_SLACK_S = 1.0


def assemble(scenario: Scenario, whole_run: dict, phases: list[dict],
             final: dict, invariants: list[dict]) -> dict:
    breaching = {o["name"] for o in whole_run["objectives"] if not o["ok"]}
    allowed = set(scenario.allowed_breaches) | set(scenario.required_breaches)
    unexpected = sorted(breaching - allowed)
    missing = sorted(set(scenario.required_breaches) - breaching)
    failed_invariants = sorted(i["name"] for i in invariants if not i["ok"])
    breaches = len(unexpected) + len(missing) + len(failed_invariants)
    return {
        "pass": breaches == 0,
        "breaches": breaches,
        "breaching_objectives": sorted(breaching),
        "unexpected_breaches": unexpected,
        "missing_required_breaches": missing,
        "failed_invariants": failed_invariants,
        "phase_slo_ok": [p["slo"]["ok"] for p in phases],
    }


def run_invariants(scenario: Scenario, world, injector, registry,
                   run_cap0: dict, run_cap1: dict) -> list[dict]:
    probes = {
        "prober_verified": _probe_prober_verified,
        "dah_byte_identical": _probe_dah_byte_identical,
        "readyz_well_ordered": _probe_readyz_well_ordered,
        "zero_undetected_sdc": _probe_zero_undetected_sdc,
        "follower_caught_up": _probe_follower_caught_up,
        "restarted_serves_from_store": _probe_restarted_serves_from_store,
        "fleet_scaled_out": _probe_fleet_scaled_out,
        "no_monotone_drift": _probe_no_monotone_drift,
        "soak_byte_identity": _probe_soak_byte_identity,
        "zero_steadystate_retraces": _probe_zero_steadystate_retraces,
        "store_recovered_writable": _probe_store_recovered_writable,
    }
    out = []
    for name in scenario.invariants:
        try:
            ok, detail = probes[name](scenario, world, injector, registry,
                                      run_cap0, run_cap1)
        except Exception as e:  # noqa: BLE001 — a crashed probe is a fail
            ok, detail = False, f"probe crashed: {e}"
        out.append({"name": name, "ok": bool(ok), "detail": detail})
    return out


def _probe_prober_verified(scenario, world, injector, registry,
                           cap0, cap1):
    """The availability signal must be real: the prober ran, counted
    accepts only after NMT verification (ok <= total by construction),
    and no load-driver client accepted an unverifiable sample either."""
    d_total = (cap1["counters"].get("probe_sample_total", 0.0)
               - cap0["counters"].get("probe_sample_total", 0.0))
    d_ok = (cap1["counters"].get("probe_sample_ok_total", 0.0)
            - cap0["counters"].get("probe_sample_ok_total", 0.0))
    verify_fail = world.das_stats.get("verify_fail", 0)
    ok = d_total > 0 and 0 <= d_ok <= d_total and verify_fail == 0
    return ok, (f"probe samples={d_total:.0f} ok={d_ok:.0f} "
                f"client_verify_failures={verify_fail}")


def _probe_dah_byte_identical(scenario, world, injector, registry,
                              cap0, cap1):
    """Every committed height's served DAH equals an independent host
    recompute from the same original shares — across GPU strikes, SDC
    quarantines, and overload, the answer bytes never moved."""
    from celestia_tpu_torch.testutil.chaosnet import extend_chain

    checked = 0
    for h in sorted(world.node.blocks):
        served = world.node.block_dah(h)
        _eds, ref = extend_chain(scenario.k, h, world.seed)
        if served.hash() != ref.hash():
            return False, f"height {h}: served DAH != host recompute"
        checked += 1
    return checked > 0, f"{checked} heights byte-identical"


def _probe_readyz_well_ordered(scenario, world, injector, registry,
                               cap0, cap1):
    """Readiness flips only when a declared degradation explains them,
    every readiness-affecting degradation actually flipped it, and the
    world ends ready (scenarios end recovered by contract)."""
    samples = world.readyz_samples
    if not samples:
        return False, "no /readyz samples recorded"
    if not any(ready for _t, ready, _f in samples):
        return False, "node never became ready"
    if samples[-1][1] is not True:
        return False, f"final /readyz not ready: {samples[-1][2]}"
    windows = [(d["t0"] - READYZ_SLACK_S,
                (d["t1"] if d["t1"] is not None else float("inf"))
                + READYZ_SLACK_S, d["kind"])
               for d in world.degradations]
    stray = [
        (t, failing) for t, ready, failing in samples
        if not ready and not any(a <= t <= b for a, b, _k in windows)
    ]
    if stray:
        return False, (f"{len(stray)} not-ready samples outside any "
                       f"degradation window; first failing={stray[0][1]}")
    # readiness-affecting degradations must be VISIBLE: a strike or a
    # quarantine that never flipped /readyz means the serving-fit
    # surface lied to the load balancer
    for d in world.degradations:
        if d["kind"] not in ("gpu_strike", "sdc", "store"):
            continue  # overload windows may never fill the queue
        t1 = d["t1"] if d["t1"] is not None else float("inf")
        seen = any(not ready and d["t0"] - READYZ_SLACK_S <= t
                   <= t1 + READYZ_SLACK_S
                   for t, ready, _f in samples)
        if not seen:
            return False, f"{d['kind']} window produced no not-ready flip"
    flips = len(world.readyz_transitions())
    return True, (f"{len(samples)} samples, {flips} transitions, "
                  f"{len(windows)} degradation windows, 0 stray")


def _probe_zero_undetected_sdc(scenario, world, injector, registry,
                               cap0, cap1):
    """Every injected bitflip at an SDC site surfaced as a detection
    (sdc_detected_total moved once per flip), every extend-path
    detection carries a quarantine + byte-identical host recompute,
    and the belt-and-braces DAH parity check caught nothing the audits
    missed."""
    injected = sum(1 for _ph, site, kind, _ord in injector.site_timeline
                   if kind == "bitflip" and site in SDC_SITES)
    detected = (cap1["counters"].get("sdc_detected_total", 0.0)
                - cap0["counters"].get("sdc_detected_total", 0.0))
    if world.sdc_missed:
        return False, (f"{len(world.sdc_missed)} device blocks diverged "
                       "the DAH without an audit detection")
    if injected != detected:
        return False, (f"injected {injected} flips but "
                       f"sdc_detected_total moved {detected:.0f}")
    bad = [d for d in world.sdc_detections
           if not d["quarantined"] or d["host_dah"] != d["reference_dah"]]
    if bad:
        return False, (f"{len(bad)} detections without matching "
                       "quarantine + byte-identical host recompute")
    if injected == 0:
        return False, "no SDC was injected — the probe is vacuous"
    return True, (f"{injected} injected == {detected:.0f} detected; "
                  f"{len(world.sdc_detections)} quarantines host-parity ok")


def _probe_restarted_serves_from_store(scenario, world, injector,
                                       registry, cap0, cap1):
    """Every restarted backend recovered purely from its on-disk block
    store: re-index found the pre-restart heights, the served DAH is
    byte-identical to the pre-restart hash, samples of a pre-restart
    height NMT-verify against it, and the backend's page-read counter
    proves the bytes came off disk (specs/store.md), not from a warm
    cache it could not have kept across the restart."""
    from celestia_tpu_torch import da

    from .world import _fetch, _verify_sample

    restarts = getattr(world, "restarts", None)
    if not restarts:
        return False, "no backend_restart was applied"
    checked = 0
    for r in restarts:
        b = world.backends[r["backend"]]
        who = f"backend {r['backend']}"
        if not r["pre_heights"]:
            return False, f"{who} had no persisted heights at restart"
        missing = sorted(set(r["pre_heights"]) - set(r["recovered_heights"]))
        if missing:
            return False, f"{who} re-index lost heights {missing}"
        h = max(r["pre_heights"])
        status, dah_doc = _fetch(b["url"], f"/dah/{h}")
        if status != 200:
            return False, f"{who} /dah/{h} -> http {status}"
        post = da.DataAvailabilityHeader.from_json(dah_doc)
        if post.hash().hex() != r["pre_dah"][h]:
            return False, f"{who} height {h}: DAH moved across restart"
        w = 2 * scenario.k
        for i, j in ((0, 0), (w // 2, w - 1)):  # an original + a parity cell
            status, body = _fetch(b["url"], f"/sample/{h}/{i}/{j}")
            if status != 200:
                return False, f"{who} /sample/{h}/{i}/{j} -> http {status}"
            if not _verify_sample(post, scenario.k, i, j, body):
                return False, (f"{who} height {h} cell ({i},{j}) failed "
                               "NMT verification")
        store = b["node"].store
        reads = store.stats().get("page_reads", 0) if store else 0
        if reads <= 0:
            return False, f"{who} served without reading its store"
        checked += 1
    return True, (f"{checked} restarted backends served NMT-verified "
                  "samples from disk with byte-identical DAHs")


def _probe_fleet_scaled_out(scenario, world, injector, registry,
                            cap0, cap1):
    """The mid-storm scale-out completed and honored the warming
    contract (ADR-023): the supervisor reached the target size with
    every member ready, every join event backfilled to at least the
    fleet head it observed (no joiner took ring traffic cold), nothing
    crash-looped, and a pre-scale-out height still serves an
    NMT-verified sample THROUGH the grown ring, byte-identical to the
    oracle's DAH."""
    from .world import _fetch, _verify_sample

    sup = getattr(world, "supervisor", None)
    if sup is None:
        return False, "world has no process-fleet supervisor"
    report = sup.report()
    target = scenario.fleet_processes
    joins = [e for e in report["events"] if e.get("event") == "join"]
    if len(joins) < target:
        return False, (f"{len(joins)} join events < target fleet size "
                       f"{target} (scale-out never completed)")
    states = [m["state"] for m in report["members"]]
    ready = sum(1 for s in states if s == "ready")
    if ready < target:
        return False, f"{ready}/{target} members ready at teardown: {states}"
    cold = [j for j in joins
            if j.get("warmed_to") is None or j["warmed_to"] < j["head"]]
    if cold:
        j = cold[0]
        return False, (f"member {j['member']} joined at warmed_to="
                       f"{j.get('warmed_to')} < head {j['head']} — the "
                       "warming contract was violated")
    if report["crashloops"]:
        return False, f"{report['crashloops']} members crash-looped"
    # a height that predates every join must still be servable through
    # the grown ring, wherever the bigger ring now places it
    h = 1
    dah = world.node.block_dah(h)
    w = 2 * scenario.k
    for i, j in ((0, 0), (w // 2, w - 1)):  # an original + a parity cell
        status, body = _fetch(world.url, f"/sample/{h}/{i}/{j}")
        if status != 200:
            return False, (f"pre-join height {h} cell ({i},{j}) -> "
                           f"http {status} through the grown ring")
        if not _verify_sample(dah, scenario.k, i, j, body):
            return False, (f"pre-join height {h} cell ({i},{j}) failed "
                           "NMT verification against the oracle DAH")
    return True, (f"{len(joins)} joins to target {target}, all warmed to "
                  f"their observed head; {report['restarts']} restarts, "
                  f"0 crashloops; pre-join height {h} NMT-verified "
                  "through the grown ring")


def _probe_no_monotone_drift(scenario, world, injector, registry,
                             cap0, cap1):
    """No recorded resource series (RSS, cache pages, store bytes, pin
    counts, latency quantiles) grew unboundedly over the soak: the
    engine's teardown ran Theil-Sen drift analysis over the .ctts
    recording (tools/tsdb.py) and every judged series came back
    not-drifting. A missing or vacuous report FAILS — a soak that
    recorded nothing proved nothing."""
    report = world.drift_report
    if not report:
        return False, ("no drift report — the recording was absent, "
                       "unreadable, or judged no series")
    judged = [d for d in report if d.get("points", 0) > 0]
    if not judged:
        return False, ("every drift series was absent from the "
                       "recording — the verdict is vacuous")
    drifting = [d for d in report if d.get("drifting")]
    if drifting:
        worst = max(drifting, key=lambda d: d.get("rel_growth", 0.0))
        return False, (f"{len(drifting)}/{len(report)} series drifting; "
                       f"worst {worst['series']}: "
                       f"rel_growth={worst['rel_growth']:.2f} over "
                       f"{worst['span_s']:.0f}s "
                       f"(increase_frac={worst['increase_frac']:.2f})")
    return True, (f"{len(judged)} series judged over the recording, "
                  f"0 drifting "
                  f"({len(report) - len(judged)} absent, not judged)")


def _probe_zero_steadystate_retraces(scenario, world, injector, registry,
                                     cap0, cap1):
    """The build watchdog saw no post-warmup rebuild of a known
    instrumented builder (ADR-011: geometry is stable in steady state). Read
    from the devledger directly — the SLO capture only freezes
    objective-referenced counters, and warmup-bracket accounting (the
    first phase is free) lives in the ledger, not the registry."""
    from celestia_tpu_torch import devledger

    events = devledger.ledger.retraces()
    if events:
        entries = sorted({e["entry"] for e in events})
        return False, (f"{len(events)} steady-state retraces on "
                       f"{entries} — geometry churned after warmup")
    if not devledger.ledger.warm:
        return False, ("warmup never ended — the watchdog judged "
                       "nothing (vacuous)")
    return True, ("0 post-warmup retraces across "
                  f"{len(devledger.ledger.debug_doc()['compile']['entries'])} "
                  "known instrumented builders")


def _probe_soak_byte_identity(scenario, world, injector, registry,
                              cap0, cap1):
    """Long-horizon serving identity: a sample anchored at height N
    must come back BYTE-IDENTICAL once the chain is soak_lag heights
    past N — across every compaction, eviction, and in-memory prune in
    between — and must still NMT-verify against the (unchanged) DAH."""
    from .world import _fetch, _verify_sample

    lag = world.soak_lag
    latest = world.node.latest_height()
    eligible = [a for a in world.soak_anchors
                if a["height"] + lag <= latest]
    if not eligible:
        return False, (f"no anchor aged past the lag: "
                       f"{len(world.soak_anchors)} anchors, head "
                       f"{latest}, lag {lag} — the soak was too short "
                       "to prove anything")
    verified = 0
    for a in eligible:
        h, i, j = a["height"], a["i"], a["j"]
        status, body = _fetch(world.url, f"/sample/{h}/{i}/{j}",
                              timeout=5.0)
        if status == 404:
            continue  # evicted by compaction: absent is honest, not wrong
        if status != 200:
            return False, f"height {h} cell ({i},{j}) -> http {status}"
        if body != a["body"]:
            return False, (f"height {h} cell ({i},{j}): served bytes "
                           f"CHANGED between height {h} and {latest}")
        dah = world.node.block_dah(h)
        if dah is None:
            return False, f"height {h}: DAH unavailable at re-verify"
        if a["dah_hash"] and dah.hash().hex() != a["dah_hash"]:
            return False, f"height {h}: DAH hash moved during the soak"
        if not _verify_sample(dah, scenario.k, i, j, body):
            return False, (f"height {h} cell ({i},{j}) failed NMT "
                           "re-verification after the lag")
        verified += 1
    if verified == 0:
        return False, (f"all {len(eligible)} aged anchors were evicted "
                       "— retention/compaction budgets leave no "
                       "window to re-verify")
    return True, (f"{verified}/{len(eligible)} aged anchors re-served "
                  f"byte-identically + NMT-verified at lag {lag} "
                  f"(head {latest}, {len(world.soak_anchors)} anchored)")


def _probe_store_recovered_writable(scenario, world, injector, registry,
                                    cap0, cap1):
    """The disk-pressure story COMPLETED (ADR-026): injected ENOSPC
    actually degraded the store (vacuous otherwise — pressure that
    never struck proved nothing), the degradation aborted puts with
    honest accounting, and the run ends with the store recovered to
    writable, gauge cleared."""
    store = getattr(world.node, "store", None)
    if store is None:
        return False, "world has no store under the node"
    entered = registry.get_counter("store_read_only_total")
    recovered = registry.get_counter("store_read_only_recovered_total")
    if entered < 1:
        return False, ("store never entered read-only — the ENOSPC "
                       "campaign never struck a put (vacuous)")
    if store.read_only:
        return False, (f"store still read-only at teardown "
                       f"({store.read_only_reason})")
    if recovered < 1:
        return False, ("store exited read-only without a recovery "
                       "event — the counter ledger is inconsistent")
    if registry.get_gauge("store_read_only") != 0.0:
        return False, "store_read_only gauge not cleared at teardown"
    aborted = registry.get_counter("store_put_aborted_total",
                                   reason="enospc")
    return True, (f"{entered:.0f} degradation(s), {recovered:.0f} "
                  f"recovery(ies), {aborted:.0f} enospc-aborted puts; "
                  "store writable at teardown")


def _probe_follower_caught_up(scenario, world, injector, registry,
                              cap0, cap1):
    """The rejoining follower converged: it reached (near) the primary
    head under fire and every installed height's DAH is byte-identical
    to the primary's."""
    if world.follower is None:
        return False, "follower was never booted"
    primary_h = world.node.latest_height()
    follower_h = world.follower.latest_height()
    if follower_h < 1:
        return False, "follower installed no heights"
    # production was frozen and settle_follower drained the remaining
    # lag before this probe, so convergence means equality
    if follower_h != primary_h:
        return False, (f"follower at {follower_h} never converged on "
                       f"frozen primary head {primary_h}")
    for h in sorted(world.follower.blocks):
        fd = world.follower.block_dah(h)
        pd = world.node.block_dah(h)
        if pd is None or fd.hash() != pd.hash():
            return False, f"height {h}: follower DAH != primary DAH"
    return True, (f"follower {follower_h}/{primary_h} heights, all "
                  f"DAHs byte-identical "
                  f"({world.follower_stats['retries_absorbed']} transport "
                  f"faults absorbed, "
                  f"{world.follower_stats['verify_rejected']} corrupted "
                  f"fetches rejected)")
