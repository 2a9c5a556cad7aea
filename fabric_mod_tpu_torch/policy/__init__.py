"""The signature-policy engine — the port's copy of fabric_mod_tpu/policy/.

Two-phase evaluation (cauthdsl), the DSL (policydsl), the compiled-
policy memo (manager), application endorsement policies (application)
and the whole-block tensor evaluator that runs on the verify mask's
device (tensorpolicy).
"""
from fabric_mod_tpu_torch.policy.cauthdsl import (  # noqa: F401
    BatchCollector, CompiledPolicy, PendingEval, PolicyError)
from fabric_mod_tpu_torch.policy.policydsl import DslError, from_string  # noqa: F401
from fabric_mod_tpu_torch.policy.manager import compile_policy_bytes  # noqa: F401
from fabric_mod_tpu_torch.policy.application import ApplicationPolicyEvaluator  # noqa: F401
