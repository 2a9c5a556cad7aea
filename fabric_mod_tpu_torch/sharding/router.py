"""ChannelShardRouter: pin N channels' commit engines to device slices
behind one shared cross-channel verify service.  The port of
fabric_mod_tpu/sharding/router.py.

The router is the ONLY stateful layer of the sharding package; it
composes:

* a :class:`~fabric_mod_tpu_torch.sharding.shardmap.ShardMap` deciding
  which slice each channel lives on (least-loaded, rebalance on leave);
* one verifier PER SLICE (``GpuVerifier(mesh=slice)`` over
  ``parallel.slice_meshes``; with no meshes, each slice a ``GpuVerifier``
  on the current card; or whatever `verifier_factory` returns) — each
  channel's validator stages its whole-block verifies (and with them its
  tensor-policy sessions) against its slice's verifier, so N channels'
  block verifies run side by side on disjoint devices;
* one :class:`~fabric_mod_tpu_torch.sharding.verifyservice.
  CrossChannelVerifyService` over those verifiers — the shared
  small-verify front door every channel's MCS and config checks
  coalesce through;
* one :class:`~fabric_mod_tpu_torch.peer.commitpipe.PipelinedCommitter`
  per channel, with the peer.Channel rebuild-on-poison contract: a
  failed pipe surfaces its error to the caller that hit it, then the
  next `pipeline_for` drains the corpse and rebuilds from the committed
  height — one bad block never bricks a channel, and never touches any
  OTHER channel's pipe or the shared flusher.

Channel join/leave goes through `add_channel`/`remove_channel`; a leave
may return the map's rebalance plan, which the router executes by
draining the moving channel's pipe (on its OLD slice) so the next
`pipeline_for` builds it pinned to the new slice (its verify handle
re-resolves the slice verifier on every call, so in-flight small
verifies need no coordination).

The reference's FABRIC_MOD_TPU_SHARDS / _SHARD_DEPTH knobs are the
`n_slices` and `depth` arguments here; the map always rebalances on
leave and the shared service keeps BatchingVerifyService's batch and
deadline (the reference's defaults).  Left out: metrics and the pipes'
consumer labels.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence

from fabric_mod_tpu_torch.bccsp.api import VerifyItem
from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
from fabric_mod_tpu_torch.sharding.shardmap import ShardMap
from fabric_mod_tpu_torch.sharding.verifyservice import (
    CrossChannelVerifyService)

log = logging.getLogger(__name__)


def _default_verifier(_index: int, mesh):
    from fabric_mod_tpu_torch.bccsp.gpu import GpuVerifier
    return GpuVerifier(mesh=mesh) if mesh is not None else GpuVerifier()


class ChannelVerifyHandle:
    """The per-channel verifier facade a Channel/TxValidator holds.

    Whole-block lanes (`verify_many_async`, `verify_many_fused_async` —
    the validator's staging seams, and with them the tensor-policy
    sessions) go STRAIGHT to the channel's slice verifier.  The
    small-verify lane (`verify_many` — MCS block checks, config
    signature sets) rides the SHARED cross-channel service, tagged, so
    it coalesces with every other channel's traffic.

    Slice resolution is per call through the router, so a rebalance
    move retargets the handle with no handshake."""

    def __init__(self, router: "ChannelShardRouter", channel_id: str):
        self._router = router
        self.channel_id = channel_id

    @property
    def slice_index(self) -> int:
        return self._router.slice_of(self.channel_id)

    def _slice_verifier(self):
        return self._router.slice_verifier(self.channel_id)

    # -- whole-block lane (slice-pinned) ---------------------------------
    def verify_many_async(self, items: Sequence[VerifyItem]):
        return self._slice_verifier().verify_many_async(items)

    def verify_many_fused_async(self, items: Sequence[VerifyItem]):
        return self._slice_verifier().verify_many_fused_async(items)

    # -- small-verify lane (shared, coalesced, tagged) -------------------
    def verify_many(self, items: Sequence[VerifyItem]):
        return self._router.service.verify_many_for(self.channel_id, items)


class _Binding:
    __slots__ = ("channel_id", "target", "handle", "pipe", "rebuild_lock")

    def __init__(self, channel_id: str, handle: ChannelVerifyHandle):
        self.channel_id = channel_id
        self.target = None                  # stage_block/commit_staged
        self.handle = handle
        self.pipe: Optional[PipelinedCommitter] = None
        self.rebuild_lock = RegisteredLock(f"sharding.rebuild[{channel_id}]")


class ChannelShardRouter:
    """Placement + aggregation over `n_slices` device slices.

    `meshes`: per-slice meshes (`parallel.slice_meshes(n)`), or None for
    unmeshed slices (each its own verifier on the current device, as on
    a one-card machine); `verifier_factory(slice_index, mesh)` builds
    each slice's verifier (default: ``GpuVerifier(mesh=mesh)``, or
    ``GpuVerifier()`` without a mesh).  `depth`: each channel's commit
    pipe depth (floor 1).  The router owns the verifiers it builds and
    the shared service; `close()` tears all of it down after draining
    every channel's pipe."""

    def __init__(self, n_slices: int = 1, meshes=None,
                 verifier_factory: Optional[Callable] = None,
                 depth: int = 2):
        if meshes is not None and len(meshes) != n_slices:
            raise ValueError(f"{len(meshes)} meshes for {n_slices} slices")
        self.map = ShardMap(n_slices)
        self._depth = max(1, depth)
        self._lock = RegisteredLock("sharding.router")
        self._bindings: Dict[str, _Binding] = {}
        self._closed = False
        factory = verifier_factory or _default_verifier
        self.verifiers = {
            i: factory(i, meshes[i] if meshes is not None else None)
            for i in range(n_slices)}
        self.service = CrossChannelVerifyService(
            self.verifiers, lambda tag: self.map.slice_of(tag, default=0))

    # -- placement --------------------------------------------------------
    def slice_of(self, channel_id: str) -> int:
        with self._lock:
            return self.map.slice_of(channel_id)

    def slice_verifier(self, channel_id: str):
        return self.verifiers[self.slice_of(channel_id)]

    def add_channel(self, channel_id: str,
                    target=None) -> ChannelVerifyHandle:
        """Place a channel and return its verify handle.  `target`
        (stage_block/commit_staged/.ledger — a peer.Channel or a
        ValidatorCommitTarget) may be bound now or later via
        `bind_target` (a Channel needs the handle BEFORE it can be
        constructed)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("shard router is closed")
            b = self._bindings.get(channel_id)
            if b is None:
                self.map.assign(channel_id)
                b = _Binding(channel_id, ChannelVerifyHandle(self, channel_id))
                self._bindings[channel_id] = b
            if target is not None:
                b.target = target
            return b.handle

    def bind_target(self, channel_id: str, target) -> None:
        with self._lock:
            self._bindings[channel_id].target = target

    def remove_channel(self, channel_id: str,
                       timeout_s: Optional[float] = None) -> List:
        """Drain + close the channel's pipe, free its slot, and execute
        the map's rebalance plan (each moved channel's pipe drains on
        its old slice; the next `pipeline_for` builds it on the new
        one).  Returns the executed move list."""
        with self._lock:
            b = self._bindings.pop(channel_id, None)
            if b is None:
                return []
            moves = self.map.release(channel_id)
        if b.pipe is not None:
            b.pipe.close(timeout_s)
        for cid, src, dst in moves:
            with self._lock:
                mb = self._bindings.get(cid)
            if mb is not None:
                # under the channel's rebuild lock: a concurrent
                # pipeline_for(cid) must not build a fresh engine while
                # the old one still drains into the same ledger
                with mb.rebuild_lock:
                    with self._lock:
                        old, mb.pipe = mb.pipe, None
                    if old is not None:
                        old.close(timeout_s)       # drain on the OLD slice
            log.info("sharding: channel %s moved slice %d -> %d",
                     cid, src, dst)
        return moves

    # -- per-channel commit engines --------------------------------------
    def pipeline_for(self, channel_id: str) -> PipelinedCommitter:
        """The channel's slice-pinned PipelinedCommitter, with the
        peer.Channel rebuild-on-poison contract: a healthy pipe is
        returned without the rebuild lock; a poisoned/closed one is
        drained and replaced (two engines never run against one ledger
        at once)."""
        def healthy():
            with self._lock:
                b = self._bindings.get(channel_id)
                if b is None:
                    raise KeyError(f"unplaced channel {channel_id!r}")
                pipe = b.pipe
            return b, (pipe if (pipe is not None and pipe.error is None
                                and not pipe.closed) else None)
        b, pipe = healthy()
        if pipe is not None:
            return pipe
        with b.rebuild_lock:
            b, pipe = healthy()
            if pipe is not None:
                return pipe                    # another caller rebuilt
            with self._lock:
                if self._closed:
                    # a submit racing close(): rebuilding here would
                    # spawn workers over torn-down verifiers that
                    # nothing would ever join
                    raise RuntimeError("shard router is closed")
            if b.target is None:
                raise RuntimeError(
                    f"channel {channel_id!r} has no commit target")
            with self._lock:
                old, b.pipe = b.pipe, None
            if old is not None:
                old.close()                    # drain the poisoned engine
            pipe = PipelinedCommitter(
                b.target, depth=self._depth,
                consumer=f"shard{self.slice_of(channel_id)}")
            with self._lock:
                b.pipe = pipe
            return pipe

    def submit_block(self, channel_id: str, block) -> None:
        self.pipeline_for(channel_id).submit(block)

    def store_block(self, channel_id: str, block):
        """Synchronous commit through the channel's pipe, with the
        one-retry-through-a-fresh-pipe arbitration of
        peer.Channel.store_block (an inherited poison fails over; an
        own-error block fails again with its real cause)."""
        pipe = self.pipeline_for(channel_id)
        try:
            return pipe.store_block(block)
        except Exception:
            retry = self.pipeline_for(channel_id)
            if retry is pipe:
                raise
            return retry.store_block(block)

    # -- lifecycle --------------------------------------------------------
    def flush(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for every channel's submitted blocks; a pipe's pending
        error raises here."""
        ok = True
        with self._lock:
            pipes = [b.pipe for b in self._bindings.values()
                     if b.pipe is not None]
        for p in pipes:
            ok = p.flush(timeout_s) and ok
        return ok

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Drain and close every channel's pipe, then the shared service
        and the verifiers the factory built.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            bindings = list(self._bindings.values())
        for b in bindings:
            # under the binding's rebuild lock: a pipeline_for rebuild
            # racing this close either finished (its fresh pipe is in
            # b.pipe and gets closed here) or blocks until we release
            # and then sees _closed and raises
            with b.rebuild_lock:
                pipe, b.pipe = b.pipe, None
            if pipe is not None:
                pipe.close(timeout_s)
        self.service.close()
        for v in self.verifiers.values():
            vclose = getattr(v, "close", None)
            if vclose is not None:
                vclose()
