"""Application (endorsement) policy evaluation — what VSCC consumes.

The port's copy of fabric_mod_tpu/policy/application.py (reference:
core/policy/application.go:115-161 `ApplicationPolicyEvaluator.Evaluate`).
An ApplicationPolicy is an inline SignaturePolicyEnvelope or a named
reference into the channel's policy tree (`PolicyManager`, from the
channel's config bundle); without a manager a reference fails with
PolicyError.
"""
from __future__ import annotations

from typing import Optional, Sequence

from fabric_mod_tpu_torch.policy.cauthdsl import BatchCollector, PolicyError
from fabric_mod_tpu_torch.policy.manager import (PolicyManager,
                                                 compile_policy_bytes)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos.protoutil import SignedData


class ApplicationPolicyEvaluator:
    # the validator passes its tensor session only to evaluators that
    # declare this — validation plugins keep the 3-arg
    # prepare(policy, sds, collector) contract untouched
    supports_tensor_session = True

    def __init__(self, msp_mgr,
                 channel_policy_manager: Optional[PolicyManager] = None,
                 sequence: int = 0):
        """`sequence` is the owning bundle's config sequence: it keys
        the shared compiled-policy memo (policy/manager.py)."""
        self._msp_mgr = msp_mgr
        self._channel_mgr = channel_policy_manager
        self._sequence = sequence
        self._compiled_cache: dict = {}

    def _resolve(self, policy_bytes: bytes):
        """ApplicationPolicy bytes -> two-phase policy object.  Inline
        signature policies are compile-cached by their (immutable)
        bytes; channel references are re-resolved on every call, as
        the reference does, so a config update that replaces the named
        policy takes effect at once."""
        cached = self._compiled_cache.get(policy_bytes)
        if cached is not None:
            return cached
        ap = m.ApplicationPolicy.decode(policy_bytes)
        if ap.signature_policy is not None:
            pol = compile_policy_bytes(ap.signature_policy.encode(),
                                       self._msp_mgr, self._sequence)
            self._compiled_cache[policy_bytes] = pol
            return pol
        if ap.channel_config_policy_reference:
            if self._channel_mgr is None:
                raise PolicyError("no channel policy manager configured")
            pol = self._channel_mgr.get_policy(
                ap.channel_config_policy_reference)
            if pol is None:
                raise PolicyError(
                    f"channel policy "
                    f"{ap.channel_config_policy_reference!r} not found")
            return pol
        raise PolicyError("empty ApplicationPolicy")

    def prepare(self, policy_bytes: bytes,
                signed_datas: Sequence[SignedData],
                collector: BatchCollector, session=None):
        return self._resolve(policy_bytes).prepare(
            signed_datas, collector, session)

    def evaluate(self, policy_bytes: bytes,
                 signed_datas: Sequence[SignedData],
                 verify_many=None) -> bool:
        return self._resolve(policy_bytes).evaluate_signed_data(
            signed_datas, verify_many)
