"""Declarative scenario engine (specs/scenarios.md, ADR-018; port of the
JAX package's scenarios/).

A Scenario is a timeline of load phases + a schedule of seeded fault
campaigns + an SLO verdict contract; ``run_scenario`` executes one and
emits a machine-readable report judged by the node's own SLO engine
and teardown invariant probes. Entirely crypto-free: the world is a
chaosnet stub app served by the real RPC stack.

    python -m celestia_tpu_torch.scenarios smoke --seed 1337 --device cuda
"""

from .engine import append_ledger, campaign_rules, run_scenario
from .library import SCENARIOS, get
from .spec import (ACTIONS, INVARIANTS, LOAD_KINDS, SDC_SITES, CampaignRule,
                   LoadSpec, Phase, Scenario)

__all__ = [
    "ACTIONS", "CampaignRule", "INVARIANTS", "LOAD_KINDS", "LoadSpec",
    "Phase", "SCENARIOS", "SDC_SITES", "Scenario", "append_ledger",
    "campaign_rules", "get", "run_scenario",
]
