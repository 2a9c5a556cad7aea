"""GuardedQueue: queue.Queue with asserted side ownership.

The port's copy of fabric_mod_tpu/concurrency/queues.py.

The threaded structures here are almost all staged pipelines whose
queues have exactly one legal consumer (a worker/sender/resolver
thread) and either one or many legal producers.  That contract is
what makes their lock-free field access safe — and it lives in
docstrings until something violates it.  GuardedQueue makes it
machine-checked: with the guards armed, a ``get`` from a thread
other than the owning consumer (or a ``put`` from a second producer
on a single-producer queue) raises RaceError at the call site.

Ownership binds on first use and transfers only from a DEAD thread:
``close()`` paths that join the worker and then drain stragglers from
the caller are legal (the join is the happens-before edge, FastTrack
style); a live worker being bypassed is exactly the race the guard
exists to catch.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

from fabric_mod_tpu_torch.concurrency.core import RaceError, enabled


class _SideOwner:
    """One side's (producer/consumer) thread pin."""

    __slots__ = ("queue_name", "role", "_owner", "_lock")

    def __init__(self, queue_name: str, role: str):
        self.queue_name = queue_name
        self.role = role
        self._owner: Optional[threading.Thread] = None
        # serializes check-then-adopt: two racing first-time callers
        # must not BOTH adopt the side — that concurrent entry is the
        # race the guard exists to catch.  Callers gate check() on
        # enabled(), so this lock costs nothing disarmed
        self._lock = threading.Lock()

    def check(self) -> None:
        me = threading.current_thread()
        with self._lock:
            owner = self._owner
            if owner is me:
                return
            if owner is None or not owner.is_alive():
                # unbound, or the old owner terminated: adopt (thread
                # teardown/join is the happens-before edge)
                self._owner = me
                return
        raise RaceError(
            f"{self.role}-side ownership violation on queue "
            f"'{self.queue_name}': touched from thread {me.name!r} "
            f"while owned by live thread {owner.name!r} — this queue "
            f"has a single legal {self.role}")

    def release(self) -> None:
        self._owner = None


class GuardedQueue:
    """queue.Queue with pinned consumer (and optional producer) side.

    `single_producer=True` additionally pins the put side to one
    thread.  The stdlib surface is preserved (put/get/*_nowait/empty/
    qsize) so it drops into every pipeline queue unchanged; with the
    guards off the overhead is one module-flag read per call.
    """

    def __init__(self, maxsize: int = 0, *, name: str,
                 single_producer: bool = False):
        self.name = name
        self._q: "queue.Queue" = queue.Queue(maxsize)
        self._consumer = _SideOwner(name, "consumer")
        self._producer = (_SideOwner(name, "producer")
                          if single_producer else None)

    # -- producer side -----------------------------------------------------
    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if enabled() and self._producer is not None:
            self._producer.check()
        self._q.put(item, block, timeout)

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    # -- consumer side -----------------------------------------------------
    def get(self, block: bool = True,
            timeout: Optional[float] = None):
        if enabled():
            self._consumer.check()
        return self._q.get(block, timeout)

    def get_nowait(self):
        return self.get(block=False)

    # -- passthrough -------------------------------------------------------
    def empty(self) -> bool:
        return self._q.empty()

    def qsize(self) -> int:
        return self._q.qsize()

    def release_consumer(self) -> None:
        """Explicit ownership handoff (rare; prefer letting the old
        consumer thread terminate)."""
        self._consumer.release()
