"""Named validation-plugin registry — the port's copy of
fabric_mod_tpu/peer/plugins.py.

(reference: core/handlers/library/registry.go:79 — the registry that
maps plugin names from chaincode definitions to validation plugin
factories — and core/handlers/validation/api's plugin contract.)

The contract here is batch-first, matching this framework's validator
pipeline: a plugin is a factory returning an EVALUATOR with

    prepare(policy_bytes, signed_datas, collector) -> pending

where `pending.finish(device_mask) -> bool` delivers the verdict after
the shared device dispatch — exactly the shape of
policy/application.ApplicationPolicyEvaluator, which backs the
built-in ``vscc``.  A definition naming an UNREGISTERED plugin fails
closed: its txs are marked INVALID_OTHER_REASON (the reference marks
txs invalid when the mapped plugin is missing).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

BUILTIN_VSCC = "vscc"


class PluginRegistry:
    """name -> evaluator factory; the factory runs ONCE per name and
    the evaluator instance is cached (resolve() sits on the per-action
    validation hot path, and stateful plugins keep their state)."""

    def __init__(self):
        self._factories: Dict[str, Callable[[], object]] = {}
        self._instances: Dict[str, object] = {}

    def register(self, name: str,
                 factory: Callable[[], object]) -> None:
        if name == BUILTIN_VSCC:
            raise ValueError("'vscc' is the built-in policy evaluator")
        self._factories[name] = factory
        self._instances.pop(name, None)

    def names(self):
        return sorted([BUILTIN_VSCC] + list(self._factories))

    def resolve(self, name: str, builtin) -> Optional[object]:
        """The evaluator for `name`; `builtin` backs ``vscc`` (and an
        empty name, which definitions may omit).  None for an unknown
        plugin — the caller fails the tx closed."""
        if name in ("", BUILTIN_VSCC):
            return builtin
        got = self._instances.get(name)
        if got is not None:
            return got
        factory = self._factories.get(name)
        if factory is None:
            return None
        got = self._instances[name] = factory()
        return got
