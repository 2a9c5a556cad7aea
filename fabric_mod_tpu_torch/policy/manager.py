"""The compiled-policy memo — the port's copy of
fabric_mod_tpu/policy/manager.py's `compile_policy_bytes` (:184).

One CompiledPolicy per (envelope bytes, config sequence) per MSP
manager, so every evaluation site of a policy shares one compile.
Weak-keyed by the manager: a new manager (a bundle swap) can never be
served policies bound to dead trust roots.  The channel policy tree
(`PolicyManager`) is not ported.
"""
from __future__ import annotations

import threading
import weakref

from fabric_mod_tpu_torch.policy.cauthdsl import CompiledPolicy
from fabric_mod_tpu_torch.protos import messages as m

_COMPILE_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_COMPILE_LOCK = threading.Lock()
_COMPILE_MEMO_CAP = 4096


def compile_policy_bytes(policy_bytes: bytes, msp_mgr,
                         sequence: int = 0) -> CompiledPolicy:
    """SignaturePolicyEnvelope bytes -> CompiledPolicy, memoized."""
    key = (bytes(policy_bytes), sequence)
    with _COMPILE_LOCK:
        per = _COMPILE_MEMO.get(msp_mgr)
        if per is None:
            per = {}
            _COMPILE_MEMO[msp_mgr] = per
        got = per.get(key)
    if got is not None:
        return got
    env = m.SignaturePolicyEnvelope.decode(policy_bytes)
    pol = CompiledPolicy(env, msp_mgr)
    with _COMPILE_LOCK:
        if len(per) >= _COMPILE_MEMO_CAP:
            # the live set (a channel's distinct policies) is tiny next
            # to the bound; overflow means sequence churn, and stale
            # epochs never hit again — reset beats LRU here
            per.clear()
        per[key] = pol
    return pol
