"""Chaincode lifecycle names the commit path reads.

The port's copy of three names of fabric_mod_tpu/peer/lifecycle.py:
`LIFECYCLE_NS`, `definition_key` and `LifecycleValidationInfo` (:218;
reference: the plugin dispatcher, plugindispatcher/dispatcher.go:102,
and the lifecycle ValidatorCommitter).  A chaincode definition lives in
the `_lifecycle` namespace under `namespaces/<cc>` and names the
namespace's validation plugin and endorsement policy; a namespace
without one validates against the channel's default policy.  The
lifecycle contract (approve, commit), its ceremony and the write-aware
split of org-local approvals are not ported.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from fabric_mod_tpu_torch.protos import messages as m

LIFECYCLE_NS = "_lifecycle"


def definition_key(cc_name: str) -> str:
    return f"namespaces/{cc_name}"


class LifecycleValidationInfo:
    """Namespace -> (plugin, policy) from committed definitions, else
    the channel default; `_lifecycle` itself is governed by
    /Channel/Application/LifecycleEndorsement."""

    def __init__(self, state_get: Callable[[str, str], Optional[bytes]],
                 default_policy: bytes,
                 lifecycle_policy: Optional[bytes] = None):
        self._state_get = state_get
        self._default = default_policy
        self._lifecycle_policy = lifecycle_policy or m.ApplicationPolicy(
            channel_config_policy_reference=
            "/Channel/Application/LifecycleEndorsement").encode()

    def validation_info(self, ns: str) -> Tuple[str, bytes]:
        if ns == LIFECYCLE_NS:
            return "vscc", self._lifecycle_policy
        raw = self._state_get(LIFECYCLE_NS, definition_key(ns))
        if raw:
            try:
                d = m.ChaincodeDefinition.decode(raw)
            except Exception:
                # a malformed on-ledger definition falls through to the
                # default policy, as the reference does
                d = None
            if d is not None and d.endorsement_policy:
                return (d.validation_plugin or "vscc",
                        d.endorsement_policy)
        return "vscc", self._default
