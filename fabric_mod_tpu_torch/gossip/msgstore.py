"""TTL'd seen-message store for duplicate suppression.

The port's copy of fabric_mod_tpu/gossip/msgstore.py (reference:
gossip/gossip/msgstore/msgs.go — messages expire by TTL, not by count,
so a burst of nonces cannot evict entries seen moments earlier and
re-admit their duplicates).

Time-bucketed sets: an insert lands in the current bucket, membership
scans the live buckets, and whole expired buckets drop in O(1).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import RegisteredLock


class TTLMessageStore:
    """`max_entries` bounds the store under a flood: past it the oldest
    buckets are evicted early.  Time is monotonic by default (`now=`
    overrides it per call)."""

    def __init__(self, ttl_s: float = 120.0, n_buckets: int = 16,
                 max_entries: int = 1_000_000):
        if n_buckets < 2:
            raise ValueError("need at least 2 buckets")
        self._width = ttl_s / n_buckets
        self._n = n_buckets
        self._max = max_entries
        self._lock = RegisteredLock("gossip.msgstore._lock")
        self._count = 0
        self._buckets: Deque[Tuple[int, set]] = deque()

    def check_and_add(self, key, now: Optional[float] = None) -> bool:
        """True if `key` is NEW (and remember it); False if it was seen
        within the TTL."""
        now = time.monotonic() if now is None else now
        idx = int(now / self._width)
        with self._lock:
            # drop whole expired buckets from the left
            while self._buckets and self._buckets[0][0] <= idx - self._n:
                self._count -= len(self._buckets.popleft()[1])
            for _, entries in self._buckets:
                if key in entries:
                    return False
            while self._count >= self._max and len(self._buckets) > 1:
                self._count -= len(self._buckets.popleft()[1])
            if self._count >= self._max:
                # a single-bucket burst has nothing older to evict:
                # refuse the insert so the bound holds ("seen" stops
                # the re-forwarding a flood would cause)
                return False
            if self._buckets and self._buckets[-1][0] == idx:
                self._buckets[-1][1].add(key)
            else:
                self._buckets.append((idx, {key}))
            self._count += 1
            return True

    def __len__(self) -> int:
        with self._lock:
            return self._count
