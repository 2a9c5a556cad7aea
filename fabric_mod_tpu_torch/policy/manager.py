"""Hierarchical policy manager, implicit meta policies and the
compiled-policy memo — the port's copy of fabric_mod_tpu/policy/manager.py.

(reference: common/policies/policy.go `ManagerImpl`/`GetPolicy` and
common/policies/implicitmeta.go.)  A channel's policy tree mirrors its
config tree: the root manager holds /Channel-level policies and child
managers (Application, Orderer, per-org groups), each with its own
named policies.  Implicit meta policies ("ANY Writers", "MAJORITY
Admins") aggregate the same-named sub-policy of every child group.

Every policy object speaks the two-phase prepare/finish protocol of
cauthdsl.py, so a whole block's policy checks share one device batch;
an implicit meta policy hands each sub-policy the block's tensor
session, so its signature sub-policies become rows of the same
whole-block evaluator pass.  Where no `verify_many` is given, a policy
verifies on the host (bccsp/sw.py), as the reference's falls back to
its MSP's software CSP.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence

from fabric_mod_tpu_torch.policy.cauthdsl import (
    BatchCollector, CompiledPolicy, PolicyError)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos.protoutil import SignedData

# Well-known policy names (reference: common/policies/policy.go:25-47)
CHANNEL_APPLICATION_READERS = "/Channel/Application/Readers"
CHANNEL_APPLICATION_WRITERS = "/Channel/Application/Writers"
CHANNEL_APPLICATION_ADMINS = "/Channel/Application/Admins"
CHANNEL_ORDERER_BLOCK_VALIDATION = "/Channel/Orderer/BlockValidation"
CHANNEL_ORDERER_WRITERS = "/Channel/Orderer/Writers"


def _host_verify_many(items):
    from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
    return SwVerifier().verify_many(items)


class _MetaPending:
    def __init__(self, pendings: List, threshold: int):
        self._pendings = pendings
        self._threshold = threshold

    def finish(self, mask) -> bool:
        got = sum(1 for p in self._pendings if p.finish(mask))
        return got >= self._threshold


class ImplicitMetaPolicyObj:
    """N-of child policies, N from ANY/ALL/MAJORITY
    (reference: common/policies/implicitmeta.go NewPolicy)."""

    def __init__(self, sub_policies: Sequence, rule: int):
        self._subs = list(sub_policies)
        n = len(self._subs)
        if rule == m.ImplicitMetaRule.ANY:
            self.threshold = 1
        elif rule == m.ImplicitMetaRule.ALL:
            self.threshold = n
        elif rule == m.ImplicitMetaRule.MAJORITY:
            self.threshold = n // 2 + 1
        else:
            raise PolicyError(f"unknown implicit meta rule {rule}")
        if n == 0:
            # pinned like the reference: a meta policy over zero
            # sub-policies can never pass (threshold 0 = fail-open)
            self.threshold = 1

    def prepare(self, signed_datas: Sequence[SignedData],
                collector: BatchCollector, session=None):
        # the meta threshold itself is a trivial host sum; the
        # sub-policies each ride the tensor session when they can
        return _MetaPending(
            [s.prepare(signed_datas, collector, session)
             for s in self._subs],
            self.threshold)

    def evaluate_signed_data(self, signed_datas: Sequence[SignedData],
                             verify_many=None) -> bool:
        collector = BatchCollector()
        pending = self.prepare(signed_datas, collector)
        mask = batch_verifier(self, verify_many)(collector.items)
        return pending.finish(mask)


def batch_verifier(policy, verify_many=None):
    """The `verify_many` callable `evaluate_signed_data` uses for this
    policy object: the given one when set, else the host verifier — so
    batched callers dispatch exactly the verifier the one-shot path
    would have."""
    if verify_many is not None:
        return verify_many
    if isinstance(policy, (CompiledPolicy, ImplicitMetaPolicyObj)):
        return _host_verify_many
    raise PolicyError(
        f"no batch verifier for policy type {type(policy).__name__}")


class PolicyManager:
    """One level of the policy tree (reference: policy.go ManagerImpl)."""

    def __init__(self, name: str = "Channel",
                 policies: Optional[Dict[str, object]] = None,
                 sub_managers: Optional[Dict[str, "PolicyManager"]] = None):
        self.name = name
        self._policies = dict(policies or {})
        self._subs = dict(sub_managers or {})

    # -- construction ----------------------------------------------------
    def add_policy(self, name: str, policy) -> None:
        self._policies[name] = policy

    def add_sub_manager(self, mgr: "PolicyManager") -> None:
        self._subs[mgr.name] = mgr

    def resolve_implicit_meta(self, name: str,
                              meta: m.ImplicitMetaPolicy) -> None:
        """Materialize an implicit meta policy over the current children
        (call after the child managers/policies exist)."""
        subs = [s._policies[meta.sub_policy] for s in self._subs.values()
                if meta.sub_policy in s._policies]
        self._policies[name] = ImplicitMetaPolicyObj(subs, meta.rule)

    # -- lookup ----------------------------------------------------------
    def sub_manager(self, name: str) -> Optional["PolicyManager"]:
        return self._subs.get(name)

    def get_policy(self, path: str):
        """Absolute ("/Channel/Application/Writers") or relative
        ("Writers") lookup; None when absent."""
        if path.startswith("/"):
            parts = [p for p in path.split("/") if p]
            if not parts or parts[0] != self.name:
                return None
            mgr: Optional[PolicyManager] = self
            for part in parts[1:-1]:
                mgr = mgr.sub_manager(part) if mgr else None
            return mgr._policies.get(parts[-1]) if mgr else None
        return self._policies.get(path)


def policy_from_proto(pol: m.Policy, msp_mgr) -> object:
    """A config-tree Policy proto -> an evaluator (signature policies
    only; implicit meta needs the tree context — use
    PolicyManager.resolve_implicit_meta)."""
    if pol.type == m.PolicyType.SIGNATURE:
        return compile_policy_bytes(pol.value, msp_mgr)
    raise PolicyError(f"unsupported policy type {pol.type}")


# ---------------------------------------------------------------------------
# Compiled-policy memo (:184): one CompiledPolicy per (envelope bytes,
# config sequence) per MSP manager, so every evaluation site of a
# policy shares one compile.  Weak-keyed by the manager: a new manager
# (a bundle swap) can never be served policies bound to dead trust
# roots.
# ---------------------------------------------------------------------------

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
