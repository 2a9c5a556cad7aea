"""Counting semaphore for service admission control.

The port's copy of fabric_mod_tpu/utils/semaphore.py.

(reference: common/semaphore/semaphore.go — the channel-based
semaphore capping the validator pool — and internal/peer/node/
grpc_limiters.go, the per-service concurrency limiters on unary and
stream RPCs.)
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional


class AcquireTimeout(Exception):
    pass


class Semaphore:
    """Bounded concurrency with an acquire timeout — the admission
    answer is "wait briefly, then shed load", never unbounded queuing
    (the reference's TryAcquire-on-context semantics)."""

    def __init__(self, permits: int):
        if permits < 1:
            raise ValueError("permits must be >= 1")
        self.permits = permits
        self._sem = threading.Semaphore(permits)

    @contextmanager
    def acquire(self, timeout_s: Optional[float] = None) -> Iterator[None]:
        if not self._sem.acquire(timeout=timeout_s):
            raise AcquireTimeout(
                f"no permit within {timeout_s}s ({self.permits} in use)")
        try:
            yield
        finally:
            self._sem.release()

    def try_acquire(self) -> bool:
        return self._sem.acquire(blocking=False)

    def release(self) -> None:
        self._sem.release()


class ServiceLimiter:
    """Named per-service semaphores (reference: grpc_limiters.go's
    map of service -> semaphore wrapped around handlers)."""

    def __init__(self, limits: dict, timeout_s: float = 5.0):
        self._sems = {name: Semaphore(n)
                      for name, n in limits.items() if n > 0}
        self._timeout = timeout_s

    @contextmanager
    def limit(self, service: str) -> Iterator[None]:
        sem = self._sems.get(service)
        if sem is None:
            yield
            return
        with sem.acquire(timeout_s=self._timeout):
            yield
