"""The arming gate of the concurrency guards.

The port's copy of the parts of fabric_mod_tpu/concurrency/core.py the
worker-thread registry needs: `RaceError` and the gate that
`assert_joined` consults.  The reference arms it from FMT_RACECHECK at
import; the port reads no environment: `enable()` or `armed()` turn it
on.  The lock-order registry and its per-thread held-lock stack come
with the rest of the concurrency package.
"""
from __future__ import annotations

import contextlib


class RaceError(AssertionError):
    """A detected race or leak (an AssertionError so test frameworks
    treat it as a hard failure, never a skip)."""


_enabled = False


def enabled() -> bool:
    """Whether the guards are armed."""
    return _enabled


def enable(on: bool) -> None:
    """Arm or disarm the guards process-wide."""
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def armed(on: bool = True):
    """Scoped enable/disable."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev
