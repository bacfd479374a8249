"""Scenario schema: the declarative surface of the scenario engine (port
of the JAX package's scenarios/spec.py; its strike actions say ``gpu_*``).

A Scenario is three things (specs/scenarios.md):

    1. a timeline of LOAD PHASES — each phase runs a set of load
       drivers (DAS sample clients, PFB broadcast storms shaped by a
       txsim TrafficProfile, a follower state-sync) for a duration;
    2. a schedule of FAULT CAMPAIGNS — CampaignRules attached to a
       phase, armed through the seeded injector with the rule's
       ``phase`` scoping (celestia_tpu_torch/faults.py): the rule is dormant
       outside its phase and re-arms nothing on exit;
    3. an SLO VERDICT contract — which objectives are allowed to
       breach, which MUST breach (a detection that fails to surface on
       the SLO board is itself a failure), and which invariant probes
       run at teardown.

Seed-reproducibility contract: campaign rules are COUNT-GATED —
``times``/``after`` on the rule's site-local hit ordinal, never
``probability`` — so the canonical fault timeline (phase, site, kind,
ordinal) is identical across runs with the same ``--seed`` as long as
each phase drives at least ``after + times`` hits to each armed site
(validated load floors; specs/scenarios.md). The seed additionally
pins the traffic shapes (blob sizes, namespaces, sample coordinates)
and every corruption payload position.
"""

from __future__ import annotations

import dataclasses

#: load driver kinds world.py implements
LOAD_KINDS = ("das", "pfb", "follower_sync", "open_das")

#: phase-boundary world actions engine.py may apply
ACTIONS = ("gpu_strike", "gpu_recover", "sdc_clear", "follower_boot",
           "backend_restart", "fleet_scale_out",
           "disk_pressure_on", "disk_pressure_off")

#: invariant probes verdict.py implements
INVARIANTS = ("prober_verified", "dah_byte_identical",
              "readyz_well_ordered", "zero_undetected_sdc",
              "follower_caught_up", "restarted_serves_from_store",
              "fleet_scaled_out", "no_monotone_drift",
              "soak_byte_identity", "zero_steadystate_retraces",
              "store_recovered_writable")

#: fault sites whose bitflips are silent-data-corruption injections —
#: the zero_undetected_sdc probe counts timeline entries at these
SDC_SITES = ("device.extend.output", "device.repair.output",
             "transfer.chunk")


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One load driver for one phase.

    ``kind='das'``: ``clients`` closed-loop light clients sampling
    random cells over the served heights, verifying every NMT proof.
    ``kind='pfb'``: ``clients`` broadcasters POSTing profile-shaped
    PFB payloads (txsim.PROFILES[profile]).
    ``kind='follower_sync'``: the booted follower node catches up from
    the primary over a real RpcClient (rides the ``rpc.get`` site).
    ``kind='open_das'``: ONE open-loop arrival process per client —
    seeded Poisson arrivals at ``rate_hz`` on an absolute schedule with
    Zipf height popularity (``profile``'s ns_skew, default
    mixed-namespaces), latency measured from the INTENDED send time so
    queue buildup is charged to the server (scenarios/openload.py).
    ``rate_hz`` caps per-client op rate; None = closed loop (required
    for ``open_das`` — an open loop IS its offered rate)."""

    kind: str
    clients: int = 1
    profile: str | None = None
    rate_hz: float | None = None

    def __post_init__(self):
        if self.kind not in LOAD_KINDS:
            raise ValueError(
                f"unknown load kind {self.kind!r}; one of {LOAD_KINDS}")
        if self.kind == "pfb" and self.profile is None:
            raise ValueError("pfb load requires a traffic profile")
        if self.kind == "open_das" and not self.rate_hz:
            raise ValueError("open_das load requires rate_hz: an "
                             "open-loop driver is DEFINED by its "
                             "offered arrival rate")


@dataclasses.dataclass(frozen=True)
class CampaignRule:
    """One count-gated fault armed for the enclosing phase only.

    Deliberately narrower than faults.FaultRule: no ``probability``
    field exists, so every campaign is deterministic by construction
    (the seed-reproducibility contract)."""

    site: str
    kind: str
    times: int = 1
    after: int = 0
    delay_s: float = 0.01
    where: str | None = None


@dataclasses.dataclass(frozen=True)
class Phase:
    """One timeline segment: loads + campaigns + boundary actions."""

    name: str
    duration_s: float
    loads: tuple[LoadSpec, ...] = ()
    campaigns: tuple[CampaignRule, ...] = ()
    enter_actions: tuple[str, ...] = ()
    exit_actions: tuple[str, ...] = ()

    def __post_init__(self):
        for a in self.enter_actions + self.exit_actions:
            if a not in ACTIONS:
                raise ValueError(f"unknown action {a!r}; one of {ACTIONS}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A full production-emulation run (see module docstring)."""

    name: str
    description: str
    phases: tuple[Phase, ...]
    # world shape
    k: int = 8
    initial_heights: int = 1
    block_interval_s: float = 0.25
    queue_capacity: int = 64
    default_deadline_s: float = 8.0
    sdc_producer: bool = False  # produce via audited device extends
    mempool_cap: int = 512
    # fleet mode (ADR-021): >0 boots that many store-backed backend
    # nodes behind a consistent-hash gateway (scenarios/fleet.py) and
    # every load/probe hits the GATEWAY url; 0 = single-node world
    fleet: int = 0
    # OS-process fleet mode (ADR-023): >0 boots ONE supervised backend
    # subprocess behind the gateway (scenarios/fleet.FleetProcessWorld,
    # node/fleet.FleetSupervisor) with the in-process primary kept OFF
    # the ring as the verification oracle; the ``fleet_scale_out``
    # action then grows the fleet to this target size under load, each
    # joiner backfilling to the fleet head before taking traffic
    fleet_processes: int = 0
    # soak shape (single-node only): a durable store under the node
    # (fsync-relaxed; the harness is throughput-bound, torn writes
    # still can't surface through the atomic rename), compaction churn
    # every N produced blocks against a byte budget, and in-memory
    # retention pruning so thousands of heights don't hold RSS hostage
    store: bool = False
    store_compact_budget_bytes: int = 0
    store_compact_every: int = 50
    retain_heights: int = 0
    # longitudinal recording: >0 starts a tsdb Scraper against the
    # node's /metrics at this cadence for the run's whole life; the
    # drift verdict and recorded-SLO replay read the .ctts it writes
    record_cadence_s: float = 0.0
    # Theil-Sen drift series judged by the no_monotone_drift invariant
    # ("name" for a recorded gauge/counter, "family:pNN" for a derived
    # histogram quantile series, e.g. "probe_sample:p99")
    drift_series: tuple[str, ...] = ()
    # soak_byte_identity: anchored samples at height N must verify
    # byte-identically once the chain reaches N + soak_sample_lag
    # (scaled down with --duration-scale, floor 10)
    soak_sample_lag: int = 0
    # verdict contract
    allowed_breaches: frozenset[str] = frozenset()
    required_breaches: frozenset[str] = frozenset()
    invariants: tuple[str, ...] = ("prober_verified", "dah_byte_identical",
                                   "readyz_well_ordered")

    def __post_init__(self):
        if not self.phases:
            raise ValueError("scenario needs at least one phase")
        names = [p.name for p in self.phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate phase names: {names}")
        for inv in self.invariants:
            if inv not in INVARIANTS:
                raise ValueError(
                    f"unknown invariant {inv!r}; one of {INVARIANTS}")
        uses_follower = any(
            ls.kind == "follower_sync" for p in self.phases for ls in p.loads)
        boots_follower = any(
            "follower_boot" in p.enter_actions for p in self.phases)
        if uses_follower and not boots_follower:
            raise ValueError("follower_sync load without a follower_boot "
                             "enter action")
        uses_restart = any(
            "backend_restart" in p.enter_actions + p.exit_actions
            for p in self.phases)
        if (uses_restart or "restarted_serves_from_store"
                in self.invariants) and self.fleet < 2:
            raise ValueError("backend_restart / restarted_serves_from_"
                             "store require fleet >= 2 (the primary "
                             "never restarts; a restartable backend "
                             "must exist)")
        if self.fleet and self.sdc_producer:
            raise ValueError("fleet mode produces through the plain "
                             "lockstep path; sdc_producer is "
                             "single-node only")
        if self.fleet_processes:
            if self.fleet:
                raise ValueError("fleet (in-process) and fleet_processes "
                                 "(OS-process) modes are mutually "
                                 "exclusive")
            if self.sdc_producer:
                raise ValueError("process-fleet mode produces through "
                                 "the plain lockstep path; sdc_producer "
                                 "is single-node only")
            if any(ls.kind == "pfb" for p in self.phases
                   for ls in p.loads):
                raise ValueError("process-fleet backends replicate the "
                                 "deterministic chain and cannot see "
                                 "the primary's mempool; pfb load is "
                                 "not supported with fleet_processes")
        uses_scale_out = any(
            "fleet_scale_out" in p.enter_actions + p.exit_actions
            for p in self.phases)
        if (uses_scale_out or "fleet_scaled_out" in self.invariants) \
                and self.fleet_processes < 2:
            raise ValueError("fleet_scale_out / fleet_scaled_out require "
                             "fleet_processes >= 2 (there must be a "
                             "target size to grow to)")
        if self.store and (self.fleet or self.fleet_processes):
            raise ValueError("the soak store rides the single-node "
                             "world; fleet modes manage their own "
                             "backend stores")
        if (self.store_compact_budget_bytes or self.retain_heights) \
                and not self.store:
            raise ValueError("compaction budget / retention require "
                             "store=True")
        uses_disk_pressure = any(
            a in ("disk_pressure_on", "disk_pressure_off")
            for p in self.phases
            for a in p.enter_actions + p.exit_actions)
        if (uses_disk_pressure or "store_recovered_writable"
                in self.invariants) and not self.store:
            raise ValueError("disk_pressure actions / store_recovered_"
                             "writable require store=True (ENOSPC "
                             "degradation needs a durable tier under "
                             "the node)")
        if "soak_byte_identity" in self.invariants and not (
                self.store and self.soak_sample_lag > 0):
            raise ValueError("soak_byte_identity requires store=True "
                             "and soak_sample_lag > 0 (an anchor must "
                             "outlive the in-memory window to prove "
                             "anything)")
        if "no_monotone_drift" in self.invariants and not (
                self.drift_series and self.record_cadence_s > 0):
            raise ValueError("no_monotone_drift requires drift_series "
                             "and record_cadence_s > 0 (the verdict "
                             "reads the recorded .ctts, not live "
                             "snapshots)")
