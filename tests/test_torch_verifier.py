"""GpuVerifier(device="cpu") against the JAX reference's
TpuVerifier(cache_size=0) on mixed raw-message and digest items,
including tampered items, within-call dedup and memo-cache hits."""
import numpy as np
import pytest
import torch

from fabric_mod_tpu.bccsp import api as japi
from fabric_mod_tpu.bccsp.tpu import TpuVerifier
from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.bccsp.api import VerifyItem
from fabric_mod_tpu_torch.utils import fixtures


@pytest.fixture(scope="module")
def mixed_items():
    """8 items (one bucket): block traffic with raw endorser messages,
    a tampered digest, a tampered message, a duplicate."""
    items, expect = fixtures.make_block(3, n_tx=2, raw_endorsers=True,
                                        adversarial=False)
    items = list(items)[:6]
    expect = list(expect)[:6]
    it = items[0]
    items.append(VerifyItem(bytes([it.digest[0] ^ 1]) + it.digest[1:],
                            it.signature, it.public_xy))
    expect.append(False)
    raw = next(x for x in items if x.message is not None)
    items.append(VerifyItem(b"", raw.signature, raw.public_xy,
                            raw.message + b"!"))
    expect.append(False)
    return items, np.array(expect)


def _reference(items):
    ref = TpuVerifier(cache_size=0)
    try:
        return np.asarray(ref.verify_many(
            [japi.VerifyItem(i.digest, i.signature, i.public_xy, i.message)
             for i in items]))
    finally:
        ref.close()


@pytest.mark.parametrize("ladder", gpu.LADDERS)
def test_verify_many_matches_reference(mixed_items, ladder):
    items, expect = mixed_items
    want = _reference(items)
    got = gpu.GpuVerifier(device="cpu", ladder=ladder).verify_many(items)
    assert got.tolist() == want.tolist() == expect.tolist()


def test_dedup_and_cache_hits(mixed_items):
    """Duplicates share one lane; a second call is served from the
    memo-cache without a device dispatch."""
    items, expect = mixed_items
    v = gpu.GpuVerifier(device="cpu")
    doubled = items[:4] + items[:4]
    first = v.verify_many(doubled)
    assert first.tolist() == expect[:4].tolist() * 2
    assert v.cache.misses == 4 and len(v.cache) == 4

    def no_dispatch(_items):
        raise AssertionError("cache hit must not dispatch")
    v._dispatch = no_dispatch
    again = v.verify_many(items[:4])
    assert again.tolist() == expect[:4].tolist()
    assert v.cache.hits == 4


def test_async_and_fused_seams_resolve_to_numpy(mixed_items):
    """verify_many_async resolves to numpy; the fused seam resolves to a
    bool tensor on the verifier's device whether every lane misses the
    cache, some hit or all do (hits scattered in and the dedup expanded
    on the device, cache write-back deferred to .writeback())."""
    items, expect = mixed_items
    v = gpu.GpuVerifier(device="cpu")
    pair = [items[0], items[1], items[0]]
    fused = v.verify_many_fused_async(pair)
    got = fused()
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    assert got.device == v.device
    assert got.tolist() == [expect[0], expect[1], expect[0]]
    assert len(v.cache) == 0
    fused.writeback()
    assert len(v.cache) == 2
    again = v.verify_many_fused_async(pair)
    assert isinstance(again(), torch.Tensor) and again().device == v.device
    assert again().tolist() == got.tolist()
    again.writeback()
    assert len(v.cache) == 2
    # two lanes hit, two miss: the misses' verdicts land among the hits
    mixed = [items[2], items[0], items[3], items[1], items[2]]
    part = v.verify_many_fused_async(mixed)
    assert isinstance(part(), torch.Tensor) and part().device == v.device
    assert part().tolist() == [expect[i] for i in (2, 0, 3, 1, 2)]
    assert len(v.cache) == 2
    part.writeback()
    assert len(v.cache) == 4
    plain = gpu.GpuVerifier(device="cpu", cache_size=0).verify_many_async(
        items[:2])()
    assert isinstance(plain, np.ndarray) and plain.tolist() == \
        expect[:2].tolist()
    assert v.verify_many([]).shape == (0,)


def test_bucket_choice():
    assert [gpu._bucket(n) for n in (1, 8, 9, 64, 65, 2048)] == \
        [8, 8, 64, 64, 512, 2048]
    with pytest.raises(ValueError):
        gpu._bucket(2049)


def test_gpu_verifier_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        gpu.GpuVerifier()
    with pytest.raises(ValueError):
        gpu.GpuVerifier(device="cpu", ladder="affine")
