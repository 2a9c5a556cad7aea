"""A manual time source for timer-driven components.

The port's copy of fabric_mod_tpu/utils/fakeclock.py `ManualClock`
(reference test model: etcd/raft drives its FSM with explicit Tick()
calls instead of wall-clock timers, which is why its election tests are
deterministic).  Tests advance time explicitly, so CPU starvation can
neither fire a spurious election nor miss a heartbeat.

A component takes a `clock` with `monotonic()`; if the clock also has
`subscribe(cb)`, the component registers a wakeup callback, and
`advance()` calls every callback after moving time, so that threads
blocked on a queue re-read their (manual) deadlines.
"""
from __future__ import annotations

from typing import Callable, List

from fabric_mod_tpu_torch.concurrency import RegisteredLock


class ManualClock:
    def __init__(self, start: float = 0.0):
        self._t = start
        self._lock = RegisteredLock("utils.fakeclock._lock")
        self._subs: List[Callable[[], None]] = []

    def monotonic(self) -> float:
        with self._lock:
            return self._t

    def subscribe(self, cb: Callable[[], None]) -> None:
        with self._lock:
            self._subs.append(cb)

    def advance(self, dt: float) -> None:
        """Move time forward and wake every subscriber."""
        assert dt >= 0
        with self._lock:
            self._t += dt
            subs = list(self._subs)
        for cb in subs:
            cb()
