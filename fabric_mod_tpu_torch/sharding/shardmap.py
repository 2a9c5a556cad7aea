"""Channel -> slice placement: deterministic, least-loaded, rebalancing
on leave.  The port's copy of fabric_mod_tpu/sharding/shardmap.py.

Pure bookkeeping on purpose — no locks, no engines, no devices.  The
router (sharding/router.py) owns serialization and the expensive
consequences of a placement decision (pipeline rebuilds, verifier
pinning); this map only answers "which slice does channel X live on"
and "which channels must MOVE now that the population changed", so
the policy is unit-testable as a function of the join/leave sequence.

Placement policy:

* `assign` puts a new channel on the least-loaded slice (ties break
  to the lowest slice index) — with equal-size slices this is the
  balanced-number-of-channels heuristic.
* `release` frees the slot and returns a bounded MOVE PLAN: the newest channels of overloaded slices move
  to underloaded ones until the spread (max load - min load) is <= 1.
  Newest-first is deliberate: the channel placed last has the least
  accumulated state on its slice, so it is the cheapest to migrate.

Determinism contract: the same join/leave sequence always produces
the same placement and the same move plans.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# (channel_id, from_slice, to_slice) — the router executes these
Move = Tuple[str, int, int]


class ShardMap:
    """Bookkeeping for N channels over `n_slices` mesh slices."""

    def __init__(self, n_slices: int):
        if n_slices <= 0:
            raise ValueError("n_slices must be positive")
        self.n_slices = n_slices
        # insertion-ordered per slice: the tail is the newest (the
        # cheapest to move)
        self._slices: List[List[str]] = [[] for _ in range(n_slices)]
        self._of: Dict[str, int] = {}

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._of)

    def __contains__(self, channel_id: str) -> bool:
        return channel_id in self._of

    def slice_of(self, channel_id: str,
                 default: Optional[int] = None) -> int:
        """The slice a channel lives on; `default` (when given) is
        returned for unknown channels — the cross-channel verify
        service routes untagged/foreign riders there instead of
        failing a whole coalesced batch on one stray tag."""
        got = self._of.get(channel_id)
        if got is None:
            if default is None:
                raise KeyError(f"unplaced channel {channel_id!r}")
            return default
        return got

    def channels(self, slice_index: int) -> List[str]:
        return list(self._slices[slice_index])

    def loads(self) -> List[int]:
        """Channels per slice, by slice index."""
        return [len(s) for s in self._slices]

    # -- mutation ---------------------------------------------------------
    def assign(self, channel_id: str) -> int:
        """Place a channel (idempotent: an already-placed channel
        keeps its slice) on the least-loaded slice."""
        got = self._of.get(channel_id)
        if got is not None:
            return got
        loads = self.loads()
        target = loads.index(min(loads))
        self._slices[target].append(channel_id)
        self._of[channel_id] = target
        return target

    def release(self, channel_id: str) -> List[Move]:
        """Remove a channel; returns the move plan restoring balance
        (empty when the spread is already <= 1).  Unknown channels are a no-op."""
        got = self._of.pop(channel_id, None)
        if got is None:
            return []
        self._slices[got].remove(channel_id)
        return self._plan_moves()

    def _plan_moves(self) -> List[Move]:
        """Move newest channels from overloaded to underloaded slices
        until the spread is <= 1; apply each move to the map as it is
        planned so the plan the router executes matches the state the
        map now describes."""
        moves: List[Move] = []
        while True:
            loads = self.loads()
            hi, lo = max(loads), min(loads)
            if hi - lo <= 1:
                return moves
            src = loads.index(hi)
            dst = loads.index(lo)
            cid = self._slices[src].pop()        # newest first
            self._slices[dst].append(cid)
            self._of[cid] = dst
            moves.append((cid, src, dst))
