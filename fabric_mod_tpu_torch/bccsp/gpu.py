"""GPU batch crypto provider — the port of fabric_mod_tpu/bccsp/tpu.py.

`GpuVerifier` has the TpuVerifier seam: ECDSA-P256 verifies are staged
into fixed-size buckets, verified in one device call each
(ops/p256.batch_verify / batch_verify_raw, whose Shamir ladder is the
hand-written CUDA kernel of ops/p256_cuda.py), and results come back
through zero-arg resolvers so the caller can overlap host work with the
device.

Kept from the reference: the buckets, vectorised marshalling
(`marshal_items` over bccsp/der.py), the verdict memo-cache
(`VerdictCache`), within-call dedup, and the fused seam that hands the
tensor-policy evaluator the verdict mask on the device.  Left out:
BatchingVerifyService, metrics, tracing, fault points, and the circuit
breaker with its software failover — a CUDA error here raises; no path
answers a device batch in software.
"""
from __future__ import annotations

import collections
import operator
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch import device as _device
from fabric_mod_tpu_torch.bccsp import der as _der
from fabric_mod_tpu_torch.bccsp.api import VerifyItem

BUCKETS = (8, 64, 512, 2048)
LADDERS = ("projective", "mixed")

# P-256 group order; the low-S bound as a big-endian byte string for the
# batched lexicographic compare (s acceptable iff s < n//2 + 1).
_P256_N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_LOW_S_BOUND = (_P256_N // 2 + 1).to_bytes(32, "big")


def _bucket(n: int, buckets: Sequence[int] = BUCKETS) -> int:
    """Smallest bucket holding n (n <= the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"no bucket >= {n} (max {buckets[-1]})")


def marshal_items(items: Sequence[VerifyItem], size: Optional[int] = None
                  ) -> Tuple[np.ndarray, ...]:
    """Whole-batch host marshalling: VerifyItems -> byte planes.

    Returns (d, r, s, qx, qy, pre_ok, msg): five (size, 32) uint8 planes
    padded to `size`, the (size,) host validity mask (DER, lengths and
    the low-S rule — False rows never yield a True verdict), and the
    message lane: None when no item carries a raw message, else
    (words, nblocks, has_msg) from der.pack_messages."""
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
            [m if m is not None else b"" for m in msgs], size,
            round_blocks_pow2=True)
        has_msg = np.zeros(size, bool)
        has_msg[:n] = [m is not None for m in msgs]
        d_ok = np.where(has_msg, msg_ok, d_ok)
        nblocks = np.where(has_msg, nblocks, 0).astype(np.int32)
        msg = (words, nblocks, has_msg)
    pre_ok = d_ok & pub_ok & der_ok & low_s
    qx = np.ascontiguousarray(pub[:, :32])
    qy = np.ascontiguousarray(pub[:, 32:])
    return d, r, s, qx, qy, pre_ok, msg


class VerdictCache:
    """Bounded LRU of (digest, signature, public key, message) -> bool.
    A verify is a pure function of that tuple, so a hit skips the
    device entirely.  Thread-safe."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._od: "collections.OrderedDict[tuple, bool]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

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
        with self._lock:
            for k in keys:
                got = self._od.get(k) if k is not None else None
                if got is not None:
                    self._od.move_to_end(k)
                    self.hits += 1
                else:
                    self.misses += 1
                out.append(got)
        return out

    def put_many(self, keys: Sequence[Optional[tuple]], verdicts) -> None:
        with self._lock:
            for k, v in zip(keys, verdicts):
                if k is None:
                    continue
                self._od[k] = bool(v)
                self._od.move_to_end(k)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)


class GpuVerifier:
    """Marshals VerifyItems to the device batch verifier.

    `device`: None (the default) runs on CUDA and raises when there is
    no card; "cpu" runs the plain PyTorch path (the tests).  `ladder`:
    "projective" (complete projective adds, the default) or "mixed"
    (affine tables + complete mixed adds) — the two CUDA kernels.
    `cache_size` bounds the verdict memo-cache (0 disables); pass a
    `VerdictCache` to share one.  Identical items in one call always
    dedup to a single device lane.  `buckets` are the batch sizes a
    call is padded to (ascending; the largest is also the chunk size
    of a larger call)."""

    def __init__(self, device=None, ladder: str = "projective",
                 cache: Optional[VerdictCache] = None,
                 cache_size: int = 8192, buckets: Sequence[int] = BUCKETS):
        if ladder not in LADDERS:
            raise ValueError(f"ladder must be one of {LADDERS}, got {ladder!r}")
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(f"buckets must be ascending sizes, got {buckets}")
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            _device.require_exact_fp32()
        self.ladder = ladder
        self.buckets = tuple(buckets)
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
        pipeline as `verify_many_async`, but when every unique lane
        misses the memo-cache the resolver returns the (n,) bool
        verdict TENSOR on the verifier's device — assembled there
        across the buckets and the dedup map, not waited for — so the
        tensor-policy evaluator consumes it without a round trip
        through the host.  The cache write-back, which needs the host
        copy, is then deferred to the resolver's `.writeback()`, which
        the consumer calls at its own sync point
        (StagedBlock.resolve_mask).  With any cache hit the resolver
        returns the numpy mask.  The values are identical either way."""
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
        if not miss_lanes:
            out = vals[lanes]
            return lambda: out
        with self._enqueue:
            verdicts = self._dispatch([uniq_items[j] for j in miss_lanes])

        if keep_device and len(miss_lanes) == len(uniq_keys):
            # every lane missed: the device tensor goes through as is,
            # the dedup expansion a gather on the device
            raw = verdicts if len(uniq_items) == n else \
                verdicts[_device.upload(lanes, self.device)]

            def finish_fused():
                return raw

            def writeback() -> None:
                if cache is not None:
                    cache.put_many(uniq_keys, verdicts.cpu().numpy())
            finish_fused.writeback = writeback
            return finish_fused
        miss_idx = np.asarray(miss_lanes)

        def finish() -> np.ndarray:
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
        from fabric_mod_tpu_torch.ops import p256
        d, r, s, qx, qy, pre_ok, msg = marshal_items(
            items, _bucket(n, self.buckets))
        pre = _device.upload(pre_ok, self.device)
        mixed = self.ladder == "mixed"
        if msg is not None:
            words, nblocks, has_msg = msg
            ok = p256.batch_verify_raw(
                words, nblocks, has_msg, d, r, s, qx, qy,
                device=self.device, mixed=mixed, lazy=True)
        else:
            ok = p256.batch_verify(d, r, s, qx, qy, device=self.device,
                                   mixed=mixed, lazy=True)
        return (ok & pre)[:n]
