"""CommitNotifier: one thread fans a ledger's commit signal out.

The port's copy of fabric_mod_tpu/ledger/notifier.py (reference: the
deliver service's CommitNotifier role — a block commit is observed
once, and every standing deliver stream is handed the signal instead
of each stream polling the tip).

One thread parks, untimed, on the source's commit condition
(`KvLedger.height_changed`, `BlockWriter.height_changed`).  When the
height advances it first runs the registered `on_commit` callbacks (the
fan-out engine materializes the new frames there, so frames are ready
before any subscriber wakes), then sets each parked waiter's private
Event: one wakeup per (commit, waiter), none while idle.

Waiters never touch the source condition: a stream waits on its own
`CommitWaiter` Event, which a cancellation (`CommitWaiter.cancel`),
`close()` or the notifier itself sets, so close latency stays bounded
without ticks.  The reference's RegisteredThread and RegisteredLock are
plain `threading` objects here.  A callback that raises is kept in
`errors` (the reference swallows it): the relay goes on, and the caller
can fail on what it kept.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Set

from fabric_mod_tpu_torch.concurrency import RegisteredLock, RegisteredThread

# how long close() waits for the relay thread to exit
JOIN_TIMEOUT_S = 10.0


class CommitWaiter:
    """One parked stream's wake handle (see CommitNotifier)."""

    __slots__ = ("event", "cancelled", "wakes")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.cancelled = False
        self.wakes = 0          # commit signals received

    def cancel(self) -> None:
        """Wake the waiter out of any pending wait (idempotent)."""
        self.cancelled = True
        self.event.set()


class CommitNotifier:
    """Fan one commit condition out to N parked waiters.

    `cond` is the source's commit condition (notified on every commit)
    and `height_fn` reads its current height; both are safe to call
    with `cond` held (the committers notify outside their store
    locks)."""

    def __init__(self, cond: threading.Condition,
                 height_fn: Callable[[], int], name: str = "commit"):
        self._cond = cond
        self._height = height_fn
        self._name = name
        self._lock = RegisteredLock(f"ledger.notifier.{name}._lock")
        self._waiters: Set[CommitWaiter] = set()
        self._callbacks: List[Callable[[int], None]] = []
        self._closed = False
        self._started = False
        self._thread: Optional[threading.Thread] = None
        # what the on-commit callbacks raised, in order
        self.errors: List[BaseException] = []

    # -- lifecycle --------------------------------------------------------
    def ensure_started(self) -> None:
        """Start the relay thread on first demand (a source with no
        parked streams never spawns it)."""
        with self._lock:
            if self._started or self._closed:
                return
            self._started = True
            self._thread = RegisteredThread(
                target=self._run, name=f"notifier-{self._name}",
                structure="CommitNotifier")
            self._thread.start()

    def close(self) -> None:
        """Stop the relay and wake every parked waiter (idempotent).
        Bounded: the relay parks untimed, but close() notifies the
        source condition, so the join is prompt."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            thread = self._thread
            waiters = list(self._waiters)
        with self._cond:
            self._cond.notify_all()
        for w in waiters:
            w.event.set()
        if thread is not None:
            thread.join(timeout=JOIN_TIMEOUT_S)
            if thread.is_alive():
                raise RuntimeError(
                    f"CommitNotifier({self._name}): the relay thread did "
                    f"not stop")

    @property
    def closed(self) -> bool:
        return self._closed

    # -- registration -----------------------------------------------------
    def on_commit(self, callback: Callable[[int], None]) -> None:
        """Run `callback(height)` on the relay thread after each height
        advance, before the waiters wake."""
        with self._lock:
            self._callbacks.append(callback)

    def waiter(self) -> CommitWaiter:
        self.ensure_started()
        w = CommitWaiter()
        with self._lock:
            self._waiters.add(w)
            if self._closed:
                w.event.set()
        return w

    def release(self, w: CommitWaiter) -> None:
        with self._lock:
            self._waiters.discard(w)

    # -- the wait (stream side) -------------------------------------------
    def wait_above(self, num: int, w: CommitWaiter,
                   timeout_s: Optional[float] = None) -> str:
        """Park until height > num: "commit", or "cancelled" / "closed"
        / "timeout".  Safe against lost wakeups: the height is re-read
        before every wait, and a commit signal arriving between the read
        and the wait sets the (still uncleared) event."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        while True:
            if self._height() > num:
                return "commit"
            if w.cancelled:
                return "cancelled"
            if self._closed:
                return "closed"
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return "timeout"
                ok = w.event.wait(timeout=remaining)
            else:
                ok = w.event.wait()
            if ok:
                w.event.clear()

    # -- the relay (notifier thread) --------------------------------------
    def _run(self) -> None:
        cond = self._cond
        last = self._height()
        while True:
            with cond:
                while not self._closed and self._height() == last:
                    cond.wait()
                if self._closed:
                    break
                h = self._height()
            last = h
            with self._lock:
                callbacks = list(self._callbacks)
                waiters = list(self._waiters)
            for cb in callbacks:
                try:
                    cb(h)
                except Exception as e:     # kept; streams re-read
                    self.errors.append(e)
            for w in waiters:
                w.wakes += 1
                w.event.set()
        # closing: hand every parked waiter the final wake
        with self._lock:
            waiters = list(self._waiters)
        for w in waiters:
            w.event.set()
