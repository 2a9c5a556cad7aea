"""Fault injection: named seams, deterministic triggers.

The port's copy of fabric_mod_tpu/faults/.  Nothing arms at import: a
plan is armed with `arm(plan)`, `active(plan)` or `arm_spec(spec)`,
where `spec` is the reference's FMT_FAULTS grammar parsed by
`FaultPlan.parse`.  Unarmed, a seam costs one None check.  See
faults/core.py for the grammar and the triggers.
"""
from fabric_mod_tpu_torch.faults.core import (FaultPlan, FaultRule,
                                              InjectedFault, active, arm,
                                              arm_spec, armed,
                                              current_plan, disarm, point)
from fabric_mod_tpu_torch.faults.points import (DECLARED_POINTS,
                                                declared_point)

__all__ = [
    "InjectedFault", "FaultRule", "FaultPlan",
    "point", "arm", "arm_spec", "disarm", "active", "armed",
    "current_plan", "DECLARED_POINTS", "declared_point",
]
