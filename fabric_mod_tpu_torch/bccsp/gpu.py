"""GPU batch crypto provider — the port of fabric_mod_tpu/bccsp/tpu.py.

`GpuVerifier` has the TpuVerifier seam: ECDSA-P256 verifies are staged
into fixed-size buckets, verified in one device call each
(ops/p256.batch_verify / batch_verify_raw, whose Shamir ladder is the
hand-written CUDA kernel of ops/p256_cuda.py), and results come back
through zero-arg resolvers so the caller can overlap host work with the
device.

Kept from the reference: the buckets, vectorised marshalling
(`marshal_items` over bccsp/der.py), the verdict memo-cache
(`VerdictCache`), within-call dedup, the fused seam that hands the
tensor-policy evaluator the verdict mask on the device, and
`BatchingVerifyService` (reference :645), which coalesces concurrent
callers' verifies into shared device batches (the staged ingress path:
orderer/stagedbroadcast.py), with the routing tag its `submit` and
`verify_many` carry for a subclass's `_route_batch` to group by
(sharding/verifyservice.py); and the mesh: `GpuVerifier(mesh=...)`
splits each bucket over the mesh's devices, one contiguous lane range
each (parallel/mesh.py).

Tracing (observability/tracing.py, armed only): a dispatch's marshal is
the "der_marshal" span; the coalescing service's flush and resolve are
"verify.flush" and "verify.resolve", linked under the first traced
submitter (reference :491, :848, :927).  `GpuVerifier(profile_dir=)`
is the device lens: with the tracer armed, the process's first dispatch
runs its marshal, launches and resolve inside one torch.profiler window
and writes the Chrome trace there (reference :495-514, whose window an
environment knob arms).  The reference's fault points
`bccsp.device.dispatch` (after the marshal) and `bccsp.device.resolve`
(in the resolver) raise to the caller for every kind.  Left out:
metrics, and the circuit breaker with its software failover — a CUDA
error here raises; no path answers a device batch in software.
"""
from __future__ import annotations

import collections
import operator
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch import device as _device
from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.bccsp import der as _der
from fabric_mod_tpu_torch.bccsp.api import VerifyItem
from fabric_mod_tpu_torch.concurrency import (GuardedQueue, RegisteredLock,
                                              RegisteredThread)
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)

BUCKETS = (8, 64, 512, 2048)
LADDERS = ("projective", "mixed")

# P-256 group order; the low-S bound as a big-endian byte string for the
# batched lexicographic compare (s acceptable iff s < n//2 + 1).
_P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_LOW_S_BOUND = (_P256_N // 2 + 1).to_bytes(32, "big")


def _bucket(n: int, min_div: int = 1, buckets: Sequence[int] = BUCKETS
            ) -> int:
    """Smallest bucket holding n that `min_div` divides (a mesh's size
    must divide the lanes it splits; n <= the largest bucket)."""
    for b in buckets:
        if n <= b and b % min_div == 0:
            return b
    raise ValueError(
        f"no bucket >= {n} divisible by {min_div} (max {buckets[-1]})")


def marshal_items(items: Sequence[VerifyItem], size: Optional[int] = None
                  ) -> Tuple[np.ndarray, ...]:
    """Whole-batch host marshalling: VerifyItems -> byte planes.

    Returns (d, r, s, qx, qy, pre_ok, msg): five (size, 32) uint8 planes
    padded to `size`, the (size,) host validity mask (DER, lengths and
    the low-S rule — False rows never yield a True verdict), and the
    message lane: None when no item carries a raw message, else
    (words, nblocks, has_msg) from der.pack_messages, as many blocks
    wide as the longest message needs (the reference rounds the width
    up to a power of two to bound its compiled shapes; the SHA-256
    kernel loops over each lane's own blocks, so the port sends no
    padding blocks)."""
    n = len(items)
    size = n if size is None else size
    msgs = [getattr(it, "message", None) for it in items]
    any_raw = any(m is not None for m in msgs)
    d, d_ok = _der.pack_fixed(
        list(map(operator.attrgetter("digest"), items)), 32, size)
    pub, pub_ok = _der.pack_fixed(
        list(map(operator.attrgetter("public_xy"), items)), 64, size)
    r, s, der_ok = _der.decode_der_batch(
        list(map(operator.attrgetter("signature"), items)), size)
    low_s = _der.lt_bytes(s, _LOW_S_BOUND)
    msg = None
    if any_raw:
        words, nblocks, msg_ok = _der.pack_messages(
            [m if m is not None else b"" for m in msgs], size)
        has_msg = np.zeros(size, bool)
        has_msg[:n] = [m is not None for m in msgs]
        d_ok = np.where(has_msg, msg_ok, d_ok)
        nblocks = np.where(has_msg, nblocks, 0).astype(np.int32)
        msg = (words, nblocks, has_msg)
    pre_ok = d_ok & pub_ok & der_ok & low_s
    qx = np.ascontiguousarray(pub[:, :32])
    qy = np.ascontiguousarray(pub[:, 32:])
    return d, r, s, qx, qy, pre_ok, msg


_CACHE_HITS_OPTS = MetricOpts(
    "fabric", "bccsp", "verdict_cache_hits",
    help="Verify verdicts served from the memo-cache (device skipped).")
_CACHE_MISSES_OPTS = MetricOpts(
    "fabric", "bccsp", "verdict_cache_misses",
    help="Verify items that had to be dispatched to the device.")
_CACHE_EVICTIONS_OPTS = MetricOpts(
    "fabric", "bccsp", "verdict_cache_evictions",
    help="LRU evictions from the verdict memo-cache.")
_CACHE_SIZE_OPTS = MetricOpts(
    "fabric", "bccsp", "verdict_cache_size",
    help="Current number of memoized verify verdicts.")


class VerdictCache:
    """Bounded LRU of (digest, signature, public key, message) -> bool.
    A verify is a pure function of that tuple, so a hit skips the
    device entirely.  Thread-safe.  `hits` and `misses` count this
    cache's probes; the reference's `fabric_bccsp_verdict_cache_*`
    series (bccsp/tpu.py:156-166) count every cache's, on the default
    metrics provider."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._od: "collections.OrderedDict[tuple, bool]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        prov = default_provider()
        self._m_hits = prov.counter(_CACHE_HITS_OPTS)
        self._m_misses = prov.counter(_CACHE_MISSES_OPTS)
        self._m_evictions = prov.counter(_CACHE_EVICTIONS_OPTS)
        self._m_size = prov.gauge(_CACHE_SIZE_OPTS)

    @staticmethod
    def key_of(item: VerifyItem) -> Optional[tuple]:
        """Hashable memo key, or None for items with non-bytes fields
        (uncacheable; never raises)."""
        key = []
        for x in (item.digest, item.signature, item.public_xy):
            if type(x) is not bytes:
                if not isinstance(x, (bytes, bytearray, memoryview)):
                    return None
                x = bytes(x)
            key.append(x)
        msg = getattr(item, "message", None)
        if msg is not None and type(msg) is not bytes:
            if not isinstance(msg, (bytes, bytearray, memoryview)):
                return None
            msg = bytes(msg)
        key.append(msg)
        return tuple(key)

    def get_many(self, keys: Sequence[Optional[tuple]]
                 ) -> List[Optional[bool]]:
        out: List[Optional[bool]] = []
        hits = 0
        with self._lock:
            for k in keys:
                got = self._od.get(k) if k is not None else None
                if got is not None:
                    self._od.move_to_end(k)
                    hits += 1
                out.append(got)
            self.hits += hits
            self.misses += len(keys) - hits
        self._m_hits.add(hits)
        self._m_misses.add(len(keys) - hits)
        return out

    def put_many(self, keys: Sequence[Optional[tuple]], verdicts) -> None:
        evicted = 0
        with self._lock:
            before = len(self._od)
            for k, v in zip(keys, verdicts):
                if k is None:
                    continue
                self._od[k] = bool(v)
                self._od.move_to_end(k)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
                evicted += 1
            delta = len(self._od) - before
        self._m_evictions.add(evicted)
        # a delta: the one exposition row totals every cache's verdicts
        self._m_size.add(delta)

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)


class GpuVerifier:
    """Marshals VerifyItems to the device batch verifier.

    `device`: None (the default) runs on CUDA and raises when there is
    no card; "cpu" runs the plain PyTorch path (the tests).  `mesh`
    (exclusive with `device`): a device tuple (parallel.data_mesh); each
    bucket then splits into one contiguous lane range per device, each
    packed, uploaded and verified on its own device, and the verdicts
    gather onto `mesh[0]` (the verifier's `device`).  The mesh size must
    divide the largest bucket; buckets it does not divide are skipped.
    `ladder`:
    "projective" (complete projective adds, the default) or "mixed"
    (affine tables + complete mixed adds) — the two CUDA kernels.
    `cache_size` bounds the verdict memo-cache (0 disables); pass a
    `VerdictCache` to share one.  Identical items in one call always
    dedup to a single device lane.  `buckets` are the batch sizes a
    call is padded to (ascending; the largest is also the chunk size
    of a larger call).  `profile_dir` arms the device lens: with the
    tracer armed, the first dispatch of the process (one-shot) runs
    inside a torch.profiler window whose Chrome trace is written there
    (`tracing.last_lens()` then holds the window's kernel launches and
    the trace's kernel events)."""

    def __init__(self, device=None, ladder: str = "projective",
                 cache: Optional[VerdictCache] = None,
                 cache_size: int = 8192, buckets: Sequence[int] = BUCKETS,
                 mesh=None, profile_dir: Optional[str] = None):
        if ladder not in LADDERS:
            raise ValueError(f"ladder must be one of {LADDERS}, got {ladder!r}")
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(f"buckets must be ascending sizes, got {buckets}")
        self.mesh = None
        if mesh is not None:
            if device is not None:
                raise ValueError("pass device OR mesh, not both")
            from fabric_mod_tpu_torch.parallel import data_mesh
            self.mesh = data_mesh(devices=mesh)
            if buckets[-1] % len(self.mesh) != 0:
                raise ValueError(
                    f"mesh size {len(self.mesh)} must divide the largest "
                    f"bucket {buckets[-1]}")
            device = self.mesh[0]
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            _device.require_exact_fp32()
        self.ladder = ladder
        self.buckets = tuple(buckets)
        self.profile_dir = profile_dir
        # one enqueue at a time: the peer's MCS and its commit pipe's
        # stage call from two threads, and two threads that each enqueue
        # thousands of small torch ops trade the GIL at every op (on the
        # CPU path, ~4x the time of the two calls one after the other)
        self._enqueue = threading.Lock()
        if cache is not None:
            self._cache = cache
        else:
            self._cache = VerdictCache(cache_size) if cache_size > 0 else None

    @property
    def cache(self) -> Optional[VerdictCache]:
        return self._cache

    def verify_many(self, items: Sequence[VerifyItem]) -> np.ndarray:
        return self.verify_many_async(items)()

    def verify_many_async(self, items: Sequence[VerifyItem]):
        """Memo-probe + dedup + marshal + enqueue on the device,
        returning a zero-arg resolver for the (n,) bool numpy
        verdicts."""
        return self._verify_async(items, keep_device=False)

    def verify_many_fused_async(self, items: Sequence[VerifyItem]):
        """The policy-fusion seam (reference: bccsp/tpu.py:361).  Same
        pipeline as `verify_many_async`, but the resolver returns the
        (n,) bool verdict TENSOR on the verifier's device — assembled
        there across the buckets, the memo-cache's hits and the dedup
        map, not waited for — so the tensor-policy evaluator consumes it
        without a round trip through the host.  The cache write-back,
        which needs the host copy, is deferred to the resolver's
        `.writeback()`, which the consumer calls at its own sync point
        (StagedBlock.resolve_mask).  The reference returns the numpy
        mask once any lane hits the cache, which sends a block whose
        creator signatures ingress already checked to the host
        evaluator; the values are identical either way."""
        return self._verify_async(items, keep_device=True)

    def _verify_async(self, items: Sequence[VerifyItem], keep_device: bool):
        n = len(items)
        if n == 0:
            return lambda: np.zeros(0, bool)
        slot_of: dict = {}
        uniq_items: List[VerifyItem] = []
        uniq_keys: List[Optional[tuple]] = []
        lanes = np.empty(n, np.int64)
        for i, it in enumerate(items):
            k = VerdictCache.key_of(it)
            lane = slot_of.get(k) if k is not None else None
            if lane is None:
                lane = len(uniq_items)
                if k is not None:
                    slot_of[k] = lane
                uniq_items.append(it)
                uniq_keys.append(k)
            lanes[i] = lane
        cache = self._cache
        cached = (cache.get_many(uniq_keys) if cache is not None
                  else [None] * len(uniq_keys))
        miss_lanes = [j for j, c in enumerate(cached) if c is None]
        vals = np.array([bool(c) for c in cached], bool)
        if not miss_lanes and not keep_device:
            out = vals[lanes]
            return lambda: out
        miss_idx = np.asarray(miss_lanes, np.int64)
        if miss_lanes:
            with self._enqueue:
                misses = [uniq_items[j] for j in miss_lanes]
                lens = tracing.device_profile_capture(
                    self.profile_dir, self.device, kernel_counts)
                if lens is None:
                    verdicts = self._dispatch(misses)
                else:
                    # the one-shot window: marshal, launches and the
                    # resolve inside it (this batch forgoes its overlap)
                    with lens:
                        verdicts = self._dispatch(misses)
                        verdicts.cpu()

        if keep_device:
            # the device tensor goes through as is when every lane
            # missed; else the hits are uploaded and the device verdicts
            # scattered into them; the dedup expansion a gather there
            if len(miss_lanes) == len(uniq_keys):
                uniq = verdicts
            else:
                uniq = _device.upload(vals, self.device)
                if miss_lanes:
                    uniq[_device.upload(miss_idx, self.device)] = verdicts
            raw = uniq if len(uniq_items) == n else \
                uniq[_device.upload(lanes, self.device)]

            def finish_fused():
                faults.point("bccsp.device.resolve")
                return raw

            def writeback() -> None:
                if cache is not None and miss_lanes:
                    cache.put_many([uniq_keys[j] for j in miss_lanes],
                                   verdicts.cpu().numpy())
            finish_fused.writeback = writeback
            return finish_fused

        def finish() -> np.ndarray:
            faults.point("bccsp.device.resolve")
            mask = verdicts.cpu().numpy()
            if cache is not None:
                cache.put_many([uniq_keys[j] for j in miss_lanes], mask)
            vals[miss_idx] = mask
            return vals[lanes]
        return finish

    def _dispatch(self, items: Sequence[VerifyItem]) -> torch.Tensor:
        """Marshal + enqueue unique items, chunked through the buckets:
        their (n,) bool verdict tensor on the device, its work enqueued
        and not waited for."""
        n = len(items)
        top = self.buckets[-1]
        if n > top:
            return torch.cat([self._dispatch(items[i:i + top])
                              for i in range(0, n, top)])
        from fabric_mod_tpu_torch.parallel import lane_ranges
        devs = self.mesh or (self.device,)
        size = _bucket(n, len(devs), self.buckets)
        with tracing.span("der_marshal", items=n, bucket=size):
            *planes, msg = marshal_items(items, size)
        faults.point("bccsp.device.dispatch")
        parts = [self._verify_lanes(
            dev, *(p[lo:hi] for p in planes),
            None if msg is None else tuple(x[lo:hi] for x in msg))
            for dev, (lo, hi) in zip(devs, lane_ranges(size, len(devs)))]
        return _gather(parts, self.device)[:n]

    def _verify_lanes(self, dev, d, r, s, qx, qy, pre_ok, msg
                      ) -> torch.Tensor:
        """One device's lane range of a bucket (the whole bucket without
        a mesh) verified on `dev`: the (lanes,) bool verdicts there,
        enqueued on its current stream."""
        from fabric_mod_tpu_torch.ops import p256
        mixed = self.ladder == "mixed"
        if msg is not None:
            words, nblocks, has_msg = msg
            return p256.batch_verify_raw(
                words, nblocks, has_msg, d, r, s, qx, qy,
                device=dev, mixed=mixed, lazy=True, pre_ok=pre_ok)
        return p256.batch_verify(d, r, s, qx, qy, device=dev, mixed=mixed,
                                 lazy=True, pre_ok=pre_ok)


def kernel_counts() -> dict:
    """{kernel name: launches so far} of the verify path's hand-written
    kernels (the ladders, the verify core, SHA-256): what the device
    lens holds its trace to."""
    from fabric_mod_tpu_torch.ops import p256_core, p256_cuda, sha256
    return {**p256_cuda.counts(), **p256_core.counts(), **sha256.counts()}


def _gather(parts: Sequence[torch.Tensor], dst: torch.device) -> torch.Tensor:
    """The mesh devices' verdict tensors concatenated on `dst`.  A copy
    from another card is ordered by PyTorch after that card's current
    stream and before `dst`'s, so it follows the chunk's kernels and
    precedes what `dst` does with the verdicts next."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dst, non_blocking=True) for p in parts])


# --- the coalescing front end (reference: bccsp/tpu.py:603-938) -------------

class VerifyDeadlineExceeded(TimeoutError):
    """The verify deadline expired before the verdict resolved: a
    DEADLINE (the device overloaded or stuck), typed apart from a device
    FAILURE (the batch raised).  Straggler futures of a timed-out
    `verify_many` fail with this same error."""

    def __init__(self, msg: str, deadline_s: Optional[float] = None):
        super().__init__(msg)
        self.deadline_s = deadline_s


def _complete(fut: Future, value=None, exc: Optional[BaseException] = None
              ) -> None:
    """Complete a future that a deadline may have failed first: the
    loser of that race must not die on InvalidStateError (a dead
    resolver thread would hang every later caller)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


class BatchingVerifyService:
    """Deadline- and size-batched verify front end with a bounded
    in-flight window.

    A flusher thread drains the submit queue into batches (a flush when
    `max_batch` items are pending or the oldest is `deadline_s` old)
    and dispatches each through the verifier's `verify_many_async` (or
    `verify_many`), then goes back to accumulating while the device
    works.  A `verify_many` call's items enter the queue as one group,
    and the flusher takes every group already queued at once, so a
    caller that formed its own cohort (a staged lane) gets one device
    call with `deadline_s=0`.  A resolver thread completes the futures
    in dispatch order.
    The queue between them holds at most `inflight_depth` batches: when
    the device falls behind, the flusher blocks — backpressure, not
    unbounded buffering.  `close()` drains: everything submitted before
    it gets a verdict.  The verifier's lifecycle stays the caller's."""

    def __init__(self, verifier, max_batch: int = 2048,
                 deadline_s: float = 0.002, inflight_depth: int = 2):
        if max_batch < 1 or inflight_depth < 1 or deadline_s < 0:
            raise ValueError("max_batch and inflight_depth must be >= 1 "
                             "and deadline_s >= 0")
        self._verifier = verifier
        self.max_batch = max_batch
        self.deadline_s = deadline_s
        self.inflight_depth = inflight_depth
        # submit queue: many producers, one consumer (the flusher);
        # in-flight queue: strictly one producer and one consumer,
        # flusher -> resolver.  Armed, the guards check both contracts.
        self._q: "GuardedQueue" = GuardedQueue(name="verify-submit")
        self._inflight: "GuardedQueue" = GuardedQueue(
            inflight_depth, name="verify-inflight", single_producer=True)
        self._stop = threading.Event()
        # orders submit against close: an item lands before close()'s
        # final drain, or is refused
        self._lifecycle = RegisteredLock("verify-service-lifecycle")
        self._resolver = RegisteredThread(
            target=self._resolve_loop, name="verify-resolver",
            structure="BatchingVerifyService")
        self._worker = RegisteredThread(
            target=self._run, name="verify-flusher",
            structure="BatchingVerifyService")
        self._resolver.start()
        self._worker.start()

    def submit(self, item: VerifyItem, tag=None) -> Future:
        """Queue one item; its future resolves to the bool verdict.
        `tag` rides with the item through the flusher; a routing
        subclass's `_route_batch` groups by it (sharding/
        verifyservice.py), this class ignores it."""
        return self._submit_group([item], tag)[0]

    def _submit_group(self, items: Sequence[VerifyItem], tag=None
                      ) -> List[Future]:
        """Queue `items` as one group of (item, future, tag) entries,
        which the flusher never splits below `max_batch`; one future
        per item."""
        group = [(item, Future(), tag) for item in items]
        if tracing.armed():
            # the caller's trace context rides the futures through the
            # flusher, so its flush and resolve spans link under it
            ctx = tracing.current_ctx()
            for _, fut, _ in group:
                fut.trace_ctx = ctx
        with self._lifecycle:
            if self._stop.is_set():
                for _, fut, _ in group:
                    fut.set_exception(RuntimeError("verify service is closed"))
            elif group:
                self._q.put(group)
        return [fut for _, fut, _ in group]

    def verify_many(self, items: Sequence[VerifyItem],
                    timeout: Optional[float] = 30.0, tag=None) -> List[bool]:
        """The policy engine's seam (GpuVerifier's shape): submit the
        items as one group and gather the verdicts.  Concurrent callers'
        groups share device batches.  `timeout` bounds the whole call
        (None waits forever); on expiry every pending future fails with
        VerifyDeadlineExceeded and the call raises it.  `tag`: as in
        `submit`."""
        futs = self._submit_group(items, tag)
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for f in futs:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                out.append(f.result(remaining))
            except FutureTimeout:
                pending = [g for g in futs if not g.done()]
                err = VerifyDeadlineExceeded(
                    f"verify deadline ({timeout}s) expired with "
                    f"{len(pending)} verdict(s) outstanding", timeout)
                for g in pending:
                    _complete(g, exc=err)
                raise err from None
        return out

    def close(self) -> None:
        """Stop both threads, draining: everything already submitted,
        batches on the device included, gets a verdict."""
        with self._lifecycle:
            self._stop.set()
        self._worker.join(timeout=60)
        self._resolver.join(timeout=60)
        # a thread that outlived its join leaves its items here: fail
        # them rather than leave a caller parked on a future (the
        # consumer pin is released first: armed, a live flusher's pin
        # would make this drain raise and strand the waiters)
        self._q.release_consumer()
        while True:
            try:
                group = self._q.get_nowait()
            except queue.Empty:
                break
            for _, fut, _ in group:
                _complete(fut, exc=RuntimeError("verify service is closed"))
        if self._worker.is_alive() or self._resolver.is_alive():
            raise RuntimeError("verify service threads did not stop")

    def _route_batch(self, batch):
        """[(verifier, sub-batch)] of (item, future, tag) entries: one
        program, one group."""
        return [(self._verifier, batch)]

    def _flush(self, batch) -> None:
        """Dispatch one batch and hand it to the resolver.  A dispatch
        that raises fails its group's futures here; a device fault
        surfaces on the resolver.  The "verify.flush" span covers the
        routing, marshal and enqueue, not the wait for an in-flight slot
        below (that is the resolver's backlog)."""
        parent = None
        if tracing.armed():
            parent = next((getattr(fut, "trace_ctx", None)
                           for _, fut, _ in batch
                           if getattr(fut, "trace_ctx", None) is not None),
                          None)
        dispatched = []
        with tracing.span("verify.flush", parent=parent,
                          items=len(batch)) as flush_span:
            for verifier, group in self._route_batch(batch):
                items = [it for it, _, _ in group]
                try:
                    async_fn = getattr(verifier, "verify_many_async", None)
                    if async_fn is not None:
                        resolve = async_fn(items)
                    else:
                        mask = verifier.verify_many(items)
                        resolve = lambda m=mask: m       # noqa: E731
                except Exception as e:               # the group's verdict
                    for _, fut, _ in group:
                        _complete(fut, exc=e)
                    continue
                dispatched.append((group, resolve, flush_span.ctx))
        for entry in dispatched:
            self._inflight.put(entry)                # blocks when full

    def _run(self) -> None:
        pending: list = []
        first_ts = 0.0
        while not self._stop.is_set():
            if pending:
                wait = max(0.0, first_ts + self.deadline_s - time.monotonic())
            else:
                wait = 0.05
            try:
                group = self._q.get(timeout=wait)
                if not pending:
                    first_ts = time.monotonic()
                pending.extend(group)
                while len(pending) < self.max_batch:  # what is queued joins
                    pending.extend(self._q.get_nowait())
            except queue.Empty:
                pass
            if pending and (len(pending) >= self.max_batch
                            or time.monotonic() - first_ts >= self.deadline_s):
                self._flush_all(pending)
                pending = []
        # closing: what was submitted before close() still gets a verdict
        while True:
            try:
                pending.extend(self._q.get_nowait())
            except queue.Empty:
                break
        self._flush_all(pending)
        self._inflight.put(None)                     # resolver: drain, exit

    def _flush_all(self, pending) -> None:
        for i in range(0, len(pending), self.max_batch):
            self._flush(pending[i:i + self.max_batch])

    def _resolve_loop(self) -> None:
        while True:
            got = self._inflight.get()
            if got is None:
                return
            group, resolve, flush_ctx = got
            try:
                # continues the flush span's trace: submit -> flusher ->
                # device -> resolver is one linked chain
                with tracing.span("verify.resolve", parent=flush_ctx,
                                  items=len(group)):
                    mask = resolve()
                for (_, fut, _), ok in zip(group, mask):
                    _complete(fut, bool(ok))
            except Exception as e:                   # the group's verdict
                for _, fut, _ in group:
                    _complete(fut, exc=e)
