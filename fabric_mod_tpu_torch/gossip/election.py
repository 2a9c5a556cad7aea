"""Per-channel leader election: who runs the deliver client.

The port's copy of fabric_mod_tpu/gossip/election.py (reference:
gossip/election/election.go — LeaderElectionService at :92, the
proposal/declaration rounds at :189-242, and the static-leader mode of
the gossip service config).

Deterministic minimum over the membership view: every peer computes
leader = min(PKI-ID) over {self} and its alive peers, so peers with the
same view agree without extra rounds; churn resolves through the
discovery heartbeats that feed the view.  `static=True/False` pins
leadership instead.

Ticking has one owner: once `start()`'s loop runs, it alone calls
`tick()` — an outside tick racing the loop could fire `on_change`
transitions out of order.  A manual `tick()` on a service whose loop
was never started, or has stopped, is the caller's to make (tests,
static mode).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from fabric_mod_tpu_torch import concurrency
from fabric_mod_tpu_torch.concurrency import (RegisteredLock, RegisteredThread,
                                              ThreadOwnership)


class LeaderElectionService:
    def __init__(self, pki_id: bytes, alive_pki_ids_fn,
                 on_change: Optional[Callable[[bool], None]] = None,
                 static: Optional[bool] = None):
        self._pki = pki_id
        self._alive = alive_pki_ids_fn     # () -> iterable of pki ids
        self._on_change = on_change
        self._static = static
        self._is_leader = bool(static) if static is not None else False
        self._lock = RegisteredLock("election")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # once start()'s loop runs, it owns ticking: an external tick()
        # racing the loop could fire on_change transitions out of
        # order.  Armed, such a tick raises.  A manual tick() on an
        # unstarted service stays legal, and after stop() the dead loop
        # thread hands ownership back.
        self._ticker = ThreadOwnership("election-ticker", live_only=True)

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._is_leader

    def tick(self) -> bool:
        """Recompute leadership; fires on_change on transitions.
        Returns the current verdict."""
        if concurrency.enabled():
            self._ticker.guard()
        if self._static is not None:
            return self._is_leader
        candidates = [self._pki] + list(self._alive())
        new = min(candidates) == self._pki
        fire = False
        with self._lock:
            if new != self._is_leader:
                self._is_leader = new
                fire = True
        if fire and self._on_change is not None:
            self._on_change(new)
        return new

    def start(self, interval_s: float = 1.0) -> None:
        def loop():
            self._ticker.claim()           # the loop owns ticking now
            while not self._stop.wait(interval_s):
                self.tick()
        self._thread = RegisteredThread(target=loop, name="election-loop",
                                        structure="LeaderElectionService")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                raise RuntimeError("the election loop did not stop")
