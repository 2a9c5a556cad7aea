"""The arming gate of the concurrency guards and the shared per-thread
held-lock stack.

The port's copy of fabric_mod_tpu/concurrency/core.py.  The reference
arms the gate from FMT_RACECHECK at import; the port reads no
environment: `enable()` or `armed()` turn it on.  The held-lock stack is
shared between `OrderedLock` and `RegisteredLock` (locks.py), so
ordering edges are observed across both kinds: an inversion between a
ranked ledger lock and a rankless gossip lock is still a cycle.
"""
from __future__ import annotations

import contextlib
import threading


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


_tls = threading.local()


def held_locks() -> list:
    """This thread's stack of (rank_or_None, lock) acquisitions."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h
