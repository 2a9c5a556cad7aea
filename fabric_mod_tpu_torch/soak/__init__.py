"""Sustained soak-under-churn: the chaos-engineering integration layer.

The port's copy of fabric_mod_tpu/soak/: mixed x509 + idemix traffic
while membership, config and faults move underneath — fingerprints
converge after every event or the run fails loudly with the seed and
schedule needed to replay it.  Every soak peer verifies on the card
through one shared verifier.  See soak/harness.py for the run loop,
soak/plan.py for the seeded event catalog, soak/invariants.py for the
steady-state contract.
"""
from fabric_mod_tpu_torch.soak.harness import (SoakConfig, SoakHarness,
                                               background_fault_plan,
                                               run_soak)
from fabric_mod_tpu_torch.soak.invariants import InvariantChecker, SoakError
from fabric_mod_tpu_torch.soak.plan import (CORE_KINDS, EVENT_KINDS,
                                            ChurnEvent, ChurnPlan)
from fabric_mod_tpu_torch.soak.workload import (MixedWorkload,
                                                committed_txids,
                                                load_idemix_fixture)
from fabric_mod_tpu_torch.soak.world import SoakPeer, SoakWorld

__all__ = [
    "SoakConfig", "SoakHarness", "run_soak", "background_fault_plan",
    "InvariantChecker", "SoakError", "ChurnPlan", "ChurnEvent",
    "EVENT_KINDS", "CORE_KINDS", "MixedWorkload", "committed_txids",
    "load_idemix_fixture", "SoakWorld", "SoakPeer",
]
