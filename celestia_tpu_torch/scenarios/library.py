"""The shipped scenario suites (`make scenario-*`, specs/scenarios.md; port
of the JAX package's scenarios/library.py: the strike actions are
``gpu_strike``/``gpu_recover`` and the disable objective is
``gpu_not_sticky_disabled``; every other field, descriptions included, is
the JAX package's).

Each is a production-emulation campaign judged by the SLO board:

    pfb-storm         sustained PFB traffic through every txsim
                      profile while a DAS flash crowd samples, with a
                      mid-storm dispatcher stall and a corrupted-body
                      burst — every default objective must HOLD.
    rolling-outage    two GPU strike/recover waves under load, each
                      with a dispatcher-delay campaign; the disable
                      counter MUST breach (the board saw the outage)
                      while availability rides through on the host
                      fallback and /readyz flips in order.
    sdc-under-storm   bitflips at device.extend.output and
                      transfer.chunk mid-storm with full audits on;
                      sdc_detected MUST breach, zero flips go
                      undetected, every quarantine recomputes a
                      byte-identical host DAH.
    rejoin-under-load a follower boots mid-storm and state-syncs from
                      the primary over a faulted transport (errors,
                      resets, a corrupted payload) while the flash
                      crowd continues; it must converge byte-identically.
    gateway-fleet     a DAS flash crowd through the consistent-hash
                      gateway over a 3-node fleet with rolling backend
                      restarts; each restarted backend must re-index
                      its on-disk block store and serve byte-identical
                      DAHs from disk (ADR-021).
    scale-out-under-load
                      a DAS flash crowd through the gateway while the
                      supervised OS-process fleet grows 1 -> 4 real
                      backend subprocesses mid-storm; every joiner
                      must backfill to the fleet head before taking
                      ring traffic and pre-join heights must still
                      NMT-verify through the grown ring (ADR-023).
    disk-pressure     open-loop DAS storm with ENOSPC injected at
                      store.write mid-storm: the store must degrade to
                      sticky read-only (visible on /readyz and the SLO
                      board via the store_writable breach) while every
                      read keeps serving from the cache tiers, then
                      recover to writable once space is freed
                      (ADR-026).
    soak              duration-scalable long-chain soak: thousands of
                      heights with store compaction churn + retention
                      pruning, judged by Theil-Sen drift over the
                      recorded .ctts series and the height-N ==
                      height-N+lag byte-identity anchors.
    das-sweep         stepped open-loop offered-load sweep emitting
                      the coordinated-omission-free latency-vs-load
                      curve with knee detection.
    smoke             the crypto-free CI gate: every engine mechanism
                      (profiles, phase-scoped campaigns, SDC drill,
                      strike/recover, windowed verdict) in a few
                      seconds.

Campaign determinism: every rule is count-gated (times/after), so the
reported fault timeline is reproducible from one --seed (the load
floors — blocks per phase, dispatch hits per phase — comfortably
exceed every rule's after+times).
"""

from __future__ import annotations

from .spec import CampaignRule, LoadSpec, Phase, Scenario


def _pfb_storm() -> Scenario:
    return Scenario(
        name="pfb-storm",
        description=("mempool-saturating PFB storm across every traffic "
                     "profile + DAS flash crowd; all SLOs must hold"),
        k=8,
        queue_capacity=64,
        block_interval_s=0.2,
        mempool_cap=256,
        phases=(
            Phase(name="small-saturation", duration_s=4.0, loads=(
                LoadSpec(kind="pfb", clients=4, profile="small-saturation"),
                LoadSpec(kind="das", clients=4),
            )),
            Phase(name="mixed-flash-crowd", duration_s=4.0, loads=(
                LoadSpec(kind="pfb", clients=3, profile="mixed-namespaces"),
                LoadSpec(kind="das", clients=8),
            ), campaigns=(
                # mid-storm dispatcher stall: bounded, so shedding (if
                # any) stays inside the rpc_admission budget
                CampaignRule(site="dispatch.run", kind="delay",
                             delay_s=0.02, times=20, after=10),
            )),
            Phase(name="huge-rollup", duration_s=4.0, loads=(
                LoadSpec(kind="pfb", clients=2, profile="huge-rollup",
                         rate_hz=4.0),
                LoadSpec(kind="das", clients=4),
            ), campaigns=(
                # a burst of corrupted request bodies: the server must
                # answer 400, never 500, and availability must not move
                CampaignRule(site="rpc.post", kind="corrupt", times=3),
            )),
        ),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered"),
    )


def _rolling_outage() -> Scenario:
    return Scenario(
        name="rolling-outage",
        description=("rolling TPU strike-outs and recoveries under "
                     "load; the SLO board must SEE the outage while "
                     "serving rides the host fallback"),
        k=8,
        queue_capacity=64,
        block_interval_s=0.2,
        phases=(
            Phase(name="steady", duration_s=3.0, loads=(
                LoadSpec(kind="das", clients=4),
                LoadSpec(kind="pfb", clients=2, profile="mixed-namespaces"),
            )),
            Phase(name="strike-1", duration_s=3.0,
                  enter_actions=("gpu_strike",),
                  exit_actions=("gpu_recover",),
                  loads=(
                      LoadSpec(kind="das", clients=6),
                  ), campaigns=(
                      CampaignRule(site="dispatch.run", kind="delay",
                                   delay_s=0.02, times=15),
                  )),
            Phase(name="recovered-1", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=4),
            )),
            Phase(name="strike-2", duration_s=3.0,
                  enter_actions=("gpu_strike",),
                  exit_actions=("gpu_recover",),
                  loads=(
                      LoadSpec(kind="das", clients=6),
                  ), campaigns=(
                      CampaignRule(site="dispatch.enqueue", kind="delay",
                                   delay_s=0.015, times=10, after=5),
                  )),
            Phase(name="recovered-2", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=4),
            )),
        ),
        # the strikes MUST surface on the board (disable counter), and
        # that is the only breach the run may show
        required_breaches=frozenset({"gpu_not_sticky_disabled"}),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered"),
    )


def _sdc_under_storm() -> Scenario:
    return Scenario(
        name="sdc-under-storm",
        description=("seeded bitflips at device.extend.output and "
                     "transfer.chunk mid-storm under full audits: "
                     "zero undetected, every quarantine host-parity"),
        k=8,
        queue_capacity=64,
        block_interval_s=0.25,
        sdc_producer=True,
        phases=(
            Phase(name="warmup", duration_s=2.5, loads=(
                LoadSpec(kind="das", clients=4),
            )),
            Phase(name="flips-mid-storm", duration_s=4.0, loads=(
                LoadSpec(kind="das", clients=6),
                LoadSpec(kind="pfb", clients=2, profile="small-saturation"),
            ), campaigns=(
                CampaignRule(site="device.extend.output", kind="bitflip",
                             times=2, after=1),
                CampaignRule(site="transfer.chunk", kind="bitflip",
                             times=1, where="scenario.stage"),
            )),
            Phase(name="recovered", duration_s=2.5,
                  enter_actions=("sdc_clear",),
                  loads=(
                      LoadSpec(kind="das", clients=4),
                  )),
        ),
        # detection IS the acceptance: the run fails unless the
        # sdc_detected objective breached during the campaign
        required_breaches=frozenset({"sdc_detected"}),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered", "zero_undetected_sdc"),
    )


def _rejoin_under_load() -> Scenario:
    return Scenario(
        name="rejoin-under-load",
        description=("a follower boots mid-storm and state-syncs from "
                     "the primary over a faulted transport while the "
                     "flash crowd continues"),
        k=8,
        queue_capacity=64,
        block_interval_s=0.25,
        phases=(
            Phase(name="steady", duration_s=2.5, loads=(
                LoadSpec(kind="das", clients=4),
                LoadSpec(kind="pfb", clients=2, profile="mixed-namespaces"),
            )),
            Phase(name="rejoin-under-fire", duration_s=5.0,
                  enter_actions=("follower_boot",),
                  loads=(
                      LoadSpec(kind="das", clients=6),
                      LoadSpec(kind="follower_sync", clients=1),
                  ), campaigns=(
                      # the rejoiner's transport is the faulted one:
                      # rpc.get fires only in node/client.RpcClient,
                      # which only the follower's sync loop uses here
                      CampaignRule(site="rpc.get", kind="error", times=2),
                      CampaignRule(site="rpc.get", kind="reset", times=1,
                                   after=6),
                      CampaignRule(site="rpc.get", kind="corrupt", times=1,
                                   after=12),
                  )),
            Phase(name="converged", duration_s=2.5, loads=(
                LoadSpec(kind="das", clients=4),
                LoadSpec(kind="follower_sync", clients=1),
            )),
        ),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered", "follower_caught_up"),
    )


def _gateway_fleet() -> Scenario:
    return Scenario(
        name="gateway-fleet",
        description=("DAS flash crowd through the consistent-hash "
                     "gateway over a 3-node fleet with rolling backend "
                     "restarts; every restarted backend must re-index "
                     "its block store and serve byte-identical DAHs "
                     "from disk"),
        k=4,
        fleet=3,
        queue_capacity=64,
        block_interval_s=0.25,
        initial_heights=2,
        phases=(
            Phase(name="warmup", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=3),
            )),
            Phase(name="flash-crowd", duration_s=3.0, loads=(
                LoadSpec(kind="das", clients=8),
            ), campaigns=(
                # a slow router mid-crowd: placement latency must not
                # move availability (the backends do the real work)
                CampaignRule(site="gateway.route", kind="delay",
                             delay_s=0.005, times=10, after=5),
            )),
            Phase(name="rolling-restart-1", duration_s=3.0,
                  enter_actions=("backend_restart",),
                  loads=(
                      LoadSpec(kind="das", clients=5),
                  )),
            Phase(name="rolling-restart-2", duration_s=3.0,
                  enter_actions=("backend_restart",),
                  loads=(
                      LoadSpec(kind="das", clients=5),
                  )),
        ),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered",
                    "restarted_serves_from_store"),
    )


def _scale_out_under_load() -> Scenario:
    return Scenario(
        name="scale-out-under-load",
        description=("DAS flash crowd through the gateway while the "
                     "OS-process fleet grows 1 -> 4 supervised backend "
                     "subprocesses mid-storm; every joiner must "
                     "re-index its store and backfill to the fleet "
                     "head before taking ring traffic, and a pre-join "
                     "height must still NMT-verify through the grown "
                     "ring (ADR-023)"),
        k=4,
        fleet_processes=4,
        queue_capacity=64,
        block_interval_s=0.25,
        initial_heights=2,
        phases=(
            Phase(name="warmup", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=3),
            )),
            # the scale-out is ASYNC: the flash crowd storms the
            # 1-process ring while three joiners spawn, re-index, and
            # backfill — the warming window is under full load
            Phase(name="scale-out-storm", duration_s=5.0,
                  enter_actions=("fleet_scale_out",),
                  loads=(
                      LoadSpec(kind="das", clients=8),
                  )),
            Phase(name="grown-steady", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=5),
            )),
        ),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered", "fleet_scaled_out"),
    )


def _disk_pressure() -> Scenario:
    return Scenario(
        name="disk-pressure",
        description=("open-loop DAS storm over a store-backed node "
                     "with ENOSPC injected at store.write mid-storm: "
                     "sticky read-only degradation that the SLO board "
                     "MUST see (store_writable breach) and /readyz "
                     "must name, zero sample-verification failures "
                     "throughout, full recovery to writable once "
                     "space is freed (ADR-026)"),
        k=4,
        queue_capacity=64,
        block_interval_s=0.25,
        initial_heights=1,
        store=True,
        phases=(
            Phase(name="steady", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=3),
            )),
            # the disk fills mid-storm: the FIRST persisted put strikes
            # ENOSPC and flips the store read-only; later strikes only
            # re-feed the sticky state if a reprobe put fires under a
            # stretched --duration-scale (count-gated headroom)
            Phase(name="pressure-storm", duration_s=4.0,
                  enter_actions=("disk_pressure_on",),
                  loads=(
                      LoadSpec(kind="das", clients=4),
                      LoadSpec(kind="open_das", clients=2, rate_hz=10.0,
                               profile="mixed-namespaces"),
                  ), campaigns=(
                      CampaignRule(site="store.write", kind="enospc",
                                   times=8),
                  )),
            # space freed as the NEXT phase's enter action (not the
            # storm's exit action): the campaign rule is already
            # dormant when try_recover probes, so recovery cannot race
            # a residual strike
            Phase(name="space-freed", duration_s=3.0,
                  enter_actions=("disk_pressure_off",),
                  loads=(
                      LoadSpec(kind="das", clients=3),
                  )),
        ),
        # the degradation MUST surface on the board — a silent
        # read-only store is the failure mode this scenario exists for
        required_breaches=frozenset({"store_writable"}),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered", "store_recovered_writable"),
    )


def _soak() -> Scenario:
    return Scenario(
        name="soak",
        description=("duration-scalable long-chain soak: thousands of "
                     "heights through store compaction churn and "
                     "in-memory retention pruning under mixed closed- "
                     "and open-loop DAS load, judged by Theil-Sen "
                     "drift over the recorded .ctts series plus the "
                     "height-N == height-N+lag byte-identity anchor "
                     "re-verification"),
        k=2,  # small squares: the soak stresses LONGEVITY, not width
        queue_capacity=64,
        block_interval_s=0.002,  # produce as fast as the store allows
        initial_heights=1,
        store=True,
        store_compact_budget_bytes=12 << 20,
        store_compact_every=50,
        retain_heights=300,
        record_cadence_s=0.25,
        soak_sample_lag=1000,
        drift_series=("process_rss_bytes", "process_open_fds",
                      "eds_cache_pages_resident", "eds_cache_pin_count",
                      "store_bytes", "probe_sample:p99",
                      "device_ledger_unattributed_bytes"),
        phases=(
            Phase(name="warmup", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=2),
            )),
            Phase(name="soak-steady", duration_s=14.0, loads=(
                LoadSpec(kind="das", clients=2),
                LoadSpec(kind="open_das", clients=1, rate_hz=25.0,
                         profile="mixed-namespaces"),
            )),
            Phase(name="cooldown", duration_s=2.0, loads=(
                LoadSpec(kind="das", clients=2),
            )),
        ),
        invariants=("prober_verified", "readyz_well_ordered",
                    "no_monotone_drift", "soak_byte_identity",
                    "zero_steadystate_retraces"),
    )


def _das_sweep() -> Scenario:
    # stepped offered-load sweep: each phase raises the OPEN-LOOP
    # arrival rate; the report's load_curve has a monotone offered
    # axis with intended-send-time latency per step and knee detection
    steps = (10.0, 25.0, 60.0, 150.0, 400.0)
    return Scenario(
        name="das-sweep",
        description=("stepped open-loop offered-load sweep over the "
                     "DAS serve path: seeded Poisson arrivals with "
                     "Zipf height popularity, latency from INTENDED "
                     "send time (coordinated-omission-free), emitting "
                     "the latency-vs-load curve + knee that replaces "
                     "single-point storm numbers"),
        k=4,
        queue_capacity=64,
        block_interval_s=0.2,
        record_cadence_s=0.25,
        phases=tuple(
            Phase(name=f"step-{int(hz)}hz", duration_s=2.5, loads=(
                LoadSpec(kind="open_das", clients=2, rate_hz=hz / 2,
                         profile="mixed-namespaces"),
            ))
            for hz in steps
        ),
        # past the knee the open loop may overrun deadlines/shed — the
        # sweep MEASURES saturation rather than forbidding it
        allowed_breaches=frozenset({"rpc_admission"}),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered"),
    )


def _smoke() -> Scenario:
    return Scenario(
        name="smoke",
        description=("crypto-free CI gate: every engine mechanism in a "
                     "few seconds — profile load, phase-scoped "
                     "campaigns, SDC drill, strike/recover, windowed "
                     "verdict"),
        k=4,
        queue_capacity=32,
        block_interval_s=0.2,
        sdc_producer=True,
        phases=(
            Phase(name="warm", duration_s=1.5, loads=(
                LoadSpec(kind="das", clients=3),
                LoadSpec(kind="pfb", clients=2, profile="small-saturation"),
            )),
            Phase(name="squall", duration_s=2.5,
                  enter_actions=("gpu_strike",),
                  exit_actions=("gpu_recover",),
                  loads=(
                      LoadSpec(kind="das", clients=4),
                      LoadSpec(kind="pfb", clients=2,
                               profile="mixed-namespaces"),
                  ), campaigns=(
                      CampaignRule(site="dispatch.run", kind="delay",
                                   delay_s=0.01, times=8),
                      CampaignRule(site="device.extend.output",
                                   kind="bitflip", times=1, after=1),
                  )),
            Phase(name="recover", duration_s=1.5,
                  enter_actions=("sdc_clear",),
                  loads=(
                      LoadSpec(kind="das", clients=3),
                  )),
        ),
        required_breaches=frozenset({"sdc_detected",
                                     "gpu_not_sticky_disabled"}),
        invariants=("prober_verified", "dah_byte_identical",
                    "readyz_well_ordered", "zero_undetected_sdc"),
    )


SCENARIOS = {
    fn().name: fn
    for fn in (_pfb_storm, _rolling_outage, _sdc_under_storm,
               _rejoin_under_load, _gateway_fleet,
               _scale_out_under_load, _disk_pressure, _soak,
               _das_sweep, _smoke)
}


def get(name: str) -> Scenario:
    try:
        return SCENARIOS[name]()
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; one of {sorted(SCENARIOS)}"
        ) from None
