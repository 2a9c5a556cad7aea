"""Lock hierarchy + the process-wide lock-order registry.

The port's copy of fabric_mod_tpu/concurrency/locks.py.

Two detectors over one shared held-stack:

* ``OrderedLock`` — the static hierarchy from the original
  utils/racecheck.py: ranks must strictly increase down the stack.
  Always on (cheap enough for production commit paths).
* ``LockOrderRegistry`` + ``RegisteredLock`` — the dynamic detector
  for locks without a natural global rank: every observed acquisition
  "A held while acquiring B" adds an A→B edge to a process-wide
  graph; the FIRST acquisition that would close a cycle (some thread
  previously observed the reverse ordering, possibly through
  intermediate locks) raises ``RaceError`` with the offending path —
  the deadlock is reported on the first interleaving that *could*
  deadlock, not the one in a thousand that does (the lockset half of
  ThreadSanitizer's hybrid detector).

Registry edges are per lock INSTANCE (no false positives from two
unrelated instances of the same structure); nodes are weakly held and
pruned so a long-lived process does not accumulate dead locks.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Set, Tuple

from fabric_mod_tpu_torch.concurrency.core import (RaceError, enabled,
                                             held_locks)


class LockOrderRegistry:
    """Process-wide acquisition-order graph with cycle detection."""

    _PRUNE_EVERY = 256

    def __init__(self):
        self._mu = threading.Lock()
        # node id -> (weakref to lock, display name)
        self._nodes: Dict[int, Tuple[weakref.ref, str]] = {}
        # node id -> successor node ids (u -> v: u held while v taken)
        self._edges: Dict[int, Set[int]] = {}
        self._observes = 0

    def _name(self, nid: int) -> str:
        node = self._nodes.get(nid)
        return node[1] if node else f"<dead lock {nid}>"

    def _node(self, lock) -> int:
        nid = id(lock)
        node = self._nodes.get(nid)
        if node is None or node[0]() is not lock:
            # fresh lock (or the id of a GC'd one, reused): (re)bind
            # and drop any edges recorded against the dead tenant
            self._nodes[nid] = (weakref.ref(lock),
                                getattr(lock, "name", repr(lock)))
            self._edges.pop(nid, None)
            for succ in self._edges.values():
                succ.discard(nid)
        return nid

    def _alive(self, nid: int) -> bool:
        node = self._nodes.get(nid)
        return node is not None and node[0]() is not None

    def _prune(self) -> None:
        dead = [nid for nid, (ref, _) in self._nodes.items()
                if ref() is None]
        for nid in dead:
            self._nodes.pop(nid, None)
            self._edges.pop(nid, None)
        for succ in self._edges.values():
            succ.difference_update(dead)

    def _path(self, src: int, dst: int) -> Optional[List[int]]:
        """A directed path src -> ... -> dst, or None (iterative DFS;
        dead nodes are skipped — their orderings died with them)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            nid, path = stack.pop()
            for nxt in self._edges.get(nid, ()):
                if nxt in seen or not self._alive(nxt):
                    continue
                if nxt == dst:
                    return path + [nxt]
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
        return None

    def observe(self, held: List[tuple], acquiring) -> None:
        """Record "each held lock precedes `acquiring`"; raise on the
        first edge that closes a cycle.  Called with the guards armed,
        before the blocking acquire (so the report fires instead of
        the deadlock)."""
        with self._mu:
            self._observes += 1
            if self._observes % self._PRUNE_EVERY == 0:
                self._prune()
            new = self._node(acquiring)
            for _, lock in held:
                if lock is acquiring:
                    continue
                h = self._node(lock)
                if h == new:
                    continue
                path = self._path(new, h)
                if path is not None:
                    chain = " -> ".join(self._name(n) for n in path)
                    raise RaceError(
                        f"lock-order cycle: acquiring "
                        f"{self._name(new)} while holding "
                        f"{self._name(h)}, but the reverse ordering "
                        f"was already observed ({chain} -> "
                        f"{self._name(new)}) — the AB/BA deadlock "
                        f"shape")
                self._edges.setdefault(h, set()).add(new)

    def clear(self) -> None:
        with self._mu:
            self._nodes.clear()
            self._edges.clear()

    def edge_count(self) -> int:
        with self._mu:
            return sum(len(s) for s in self._edges.values())


_registry = LockOrderRegistry()


def lock_registry() -> LockOrderRegistry:
    """The process-wide registry (one graph for the whole suite)."""
    return _registry


class OrderedLock:
    """An RLock with a rank in a global hierarchy: a thread may only
    acquire ranks STRICTLY ABOVE the highest it already holds (re-
    entry on the same lock is fine).  Any inversion — the classic
    AB/BA deadlock shape — raises RaceError at acquire time, on the
    first interleaving that exhibits it, instead of deadlocking one
    run in a thousand.  The rank check is always on (production
    commit paths run it); with the guards armed the acquisition also
    feeds the process-wide lock-order registry so cycles spanning
    ranked and rank-less locks are caught too."""

    def __init__(self, rank: int, name: str = ""):
        self.rank = rank
        self.name = name or f"lock@{rank}"
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = held_locks()
        # Re-entry of ANY already-held lock is always safe (RLock) and
        # exempt from the rank rule — scan the whole held stack, not
        # just its top: ledger(10) -> pvtstore(30) -> ledger(10) again
        # cannot deadlock, and the checker runs live on production
        # commit paths where a false positive would abort commits.
        # Fresh locks still check against the HIGHEST held rank (not
        # the stack top — after a re-entry the top can be a low rank
        # that would mask a real inversion against a lock in between).
        if held and not any(h[1] is self for h in held):
            ranked = [h for h in held if h[0] is not None]
            if ranked:
                top_rank, top_lock = max(ranked, key=lambda h: h[0])
                if top_rank >= self.rank:
                    raise RaceError(
                        f"lock-order violation: acquiring {self.name} "
                        f"(rank {self.rank}) while holding "
                        f"{top_lock.name} (rank {top_rank}) — the "
                        f"hierarchy requires strictly increasing ranks")
            if enabled():
                _registry.observe(held, self)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append((self.rank, self))
        return ok

    def release(self):
        held = held_locks()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


class RegisteredLock:
    """A named re-entrant mutex feeding the lock-order registry.

    The drop-in replacement for the plain ``threading.Lock``/``RLock``
    mutexes of the threaded structures (gossip comm, the batching
    verify service, the commit pipeline, election, the gossip drain
    loop): with the guards off it is a bare RLock (no
    bookkeeping at all); armed, every nested acquisition records its
    ordering and the first observed inversion raises at acquire time.

    Works as the lock behind a ``threading.Condition`` too — the
    ``_is_owned``/``_release_save``/``_acquire_restore`` protocol
    delegates to the inner RLock and keeps the held-stack honest
    across ``cond.wait()``.
    """

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    # -- lock surface ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        if enabled():
            held = held_locks()
            if not any(h[1] is self for h in held):
                _registry.observe(held, self)
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                held.append((None, self))
            return ok
        return self._lock.acquire(blocking, timeout)

    def release(self):
        held = held_locks()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    # -- Condition protocol (CPython delegation) ---------------------------
    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        # cond.wait() fully releases the lock: drop our bookkeeping so
        # the blocked thread does not appear to hold it (edges observed
        # while parked in wait() would be false orderings)
        held = held_locks()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is self:
                del held[i]
                break
        return self._lock._release_save()

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        held_locks().append((None, self))
