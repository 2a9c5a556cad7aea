"""The shared cross-channel verify front door: one flusher, per-slice
dispatch groups, tagged futures routing verdicts back per channel.  The
port of fabric_mod_tpu/sharding/verifyservice.py.

The base :class:`BatchingVerifyService` (bccsp/gpu.py) coalesces
concurrent submitters into deadline/size-batched dispatches against ONE
verifier; this subclass keeps that single flusher (one deadline clock,
one coalescing window for the whole process) and splits each coalesced
batch at flush time into per-slice groups — each group one call into
its slice's verifier.  The submit tag (the channel id) picks the group
through the shard map, so

* a small channel's stray verifies ride the same flush window as a big
  channel's storm instead of each paying its own dispatch latency, and
* per-slice groups FAIL independently: an error raised by channel A's
  slice verifier completes only A's group's futures with it — channel
  B's riders in the same flush window resolve normally.

Whole-block batches do NOT come through here: the router pins each
channel's validator to its slice verifier directly.  This service is
the small-verify lane: gossip block verifies, config signature sets,
broadcast filters.

A group goes to its slice verifier through `_SliceLane`, whose call
is the "shard.dispatch" span (tracer armed; reference :62).  Left out:
the reference's fault point and metric; `flushes` and `groups` (per
slice) are plain counters (read by chip_smoke.py).  Untagged and
unknown tags take slice 0, the reference's default slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

from fabric_mod_tpu_torch.bccsp.api import VerifyItem
from fabric_mod_tpu_torch.bccsp.gpu import BatchingVerifyService
from fabric_mod_tpu_torch.observability import tracing

DEFAULT_SLICE = 0


class _SliceLane:
    """One slice's verifier as the flusher calls it: each group's
    dispatch timed as the "shard.dispatch" span."""

    def __init__(self, index: int, verifier):
        self.index = index
        self.verifier = verifier

    def verify_many_async(self, items: Sequence[VerifyItem]):
        with tracing.span("shard.dispatch", slice=self.index,
                          items=len(items)):
            fn = getattr(self.verifier, "verify_many_async", None)
            if fn is not None:
                return fn(items)
            mask = self.verifier.verify_many(items)
            return lambda: mask


class CrossChannelVerifyService(BatchingVerifyService):
    """BatchingVerifyService over a DICT of per-slice verifiers.

    `verifiers`: slice index -> verifier (a GpuVerifier per slice, or
    any verify_many[_async]-shaped object), slice 0 among them.
    `shard_of(tag) -> slice`: the placement lookup (ShardMap.slice_of
    with a default) — it must ACCEPT unknown tags (route them to a
    default slice) rather than raise, because one stray tag must never
    fail a whole coalesced batch.  Untagged submits route to slice 0.
    `kwargs` go to BatchingVerifyService (max_batch, deadline_s,
    inflight_depth).

    Verifier lifecycle stays with the caller (the router): slices are
    shared with the per-channel block path, so close() here stops only
    the flusher and resolver threads."""

    def __init__(self, verifiers: Dict[int, object],
                 shard_of: Callable[[object], int], **kwargs):
        if DEFAULT_SLICE not in verifiers:
            raise ValueError(f"need a verifier for slice {DEFAULT_SLICE}")
        self.verifiers = dict(verifiers)
        self._shard_of = shard_of
        self.flushes = 0                  # routed batches (flusher thread)
        self.groups = {i: 0 for i in self.verifiers}   # dispatch groups
        self._lanes = {i: _SliceLane(i, v) for i, v in self.verifiers.items()}
        super().__init__(verifier=self.verifiers[DEFAULT_SLICE], **kwargs)

    # -- per-channel surface ---------------------------------------------
    def verify_many_for(self, channel_id: str,
                        items: Sequence[VerifyItem], timeout=30.0):
        return self.verify_many(items, timeout=timeout, tag=channel_id)

    # -- the routed flush -------------------------------------------------
    def _route_batch(self, batch):
        """Group one coalesced batch by slice.  Slice order is sorted so
        the dispatch order (and with it the resolver's completion
        order) is deterministic for a given batch."""
        self.flushes += 1
        groups: Dict[int, list] = {}
        for entry in batch:
            tag = entry[2]
            s = DEFAULT_SLICE if tag is None else self._shard_of(tag)
            if s not in self.verifiers:
                s = DEFAULT_SLICE
            groups.setdefault(s, []).append(entry)
        for s in groups:
            self.groups[s] += 1
        return [(self._lanes[s], groups[s]) for s in sorted(groups)]
