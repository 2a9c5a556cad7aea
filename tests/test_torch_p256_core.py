"""The port's verify core against the JAX reference's p256.verify_core on
the adversarial set at batch 8 (the sigbatch shape of tests/test_p256.py):
valid, tampered digest, wrong key, tampered r, s = 0, r >= n, off-curve
key, key (0, 0), and the high-S mirror (accepted by the core; low-S is
a host rule).  Both port ladders must give the reference's verdicts,
through the CPU path (the kernels' plain versions) and through the CUDA
core's per-lane code built by the host compiler."""
import numpy as np
import pytest
import torch

from fabric_mod_tpu.ops import p256 as jp
from fabric_mod_tpu_torch.ops import p256 as tp
from fabric_mod_tpu_torch.ops import p256_core
from fabric_mod_tpu_torch.utils import fixtures
from tests import _torch_core_shim as shim


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain limb code is many small ops: one intra-op thread a
    worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def adversarial_batch():
    d, r, s, qx, qy, _ = fixtures.signature_arrays(8, tamper_last=False)
    d, r, s, qx, qy = (a.copy() for a in (d, r, s, qx, qy))
    items, _ = fixtures.make_verify_items(3, n_keys=3, seed=b"other")
    d[0][5] ^= 1                                       # tampered digest
    qx[1] = np.frombuffer(items[1].public_xy[:32], np.uint8)   # wrong key
    qy[1] = np.frombuffer(items[1].public_xy[32:], np.uint8)
    r[2][31] ^= 0xFF                                   # r tampered
    s[3][:] = 0                                        # s = 0
    r[4][:] = np.frombuffer(tp.N.to_bytes(32, "big"), np.uint8)   # r = n
    qy[5][31] ^= 1                                     # off-curve key
    s_int = int.from_bytes(bytes(s[6]), "big")         # high-S mirror
    s[6] = np.frombuffer((tp.N - s_int).to_bytes(32, "big"), np.uint8)
    qx[7][:] = 0                                       # key (0, 0)
    qy[7][:] = 0
    return d, r, s, qx, qy


@pytest.fixture(scope="module")
def reference_verdicts(adversarial_batch):
    import jax.numpy as jnp
    args, range_ok = jp.marshal_inputs(*adversarial_batch)
    ok = np.asarray(jp.verify_core(*(jnp.asarray(a) for a in args)))
    return ok & range_ok


@pytest.mark.parametrize("mixed", [False, True], ids=["projective", "mixed"])
def test_verify_core_matches_reference(adversarial_batch, reference_verdicts,
                                       mixed):
    got = tp.batch_verify(*adversarial_batch, device="cpu", mixed=mixed)
    assert got.tolist() == reference_verdicts.tolist()
    assert got.tolist() == [False, False, False, False, False, False,
                            True, False]


@pytest.fixture(scope="module")
def core_lib(tmp_path_factory):
    lib = shim.build(tmp_path_factory.mktemp("core_shim"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def test_cuda_core_lanes_match_reference(adversarial_batch,
                                         reference_verdicts, core_lib):
    """The CUDA core's own arithmetic — the prologue and epilogue lanes
    of csrc/p256_core.cu built by the host compiler, around the plain
    ladder — gives the reference verify_core's verdicts."""
    planes, range_ok, rn_lt_p = tp.range_checks(*adversarial_batch)
    packed = p256_core.pack(planes, range_ok, np.ones(len(range_ok), bool),
                            rn_lt_p)
    ok, _, _ = shim.run_core(core_lib, packed)
    assert ok.tolist() == reference_verdicts.tolist()


def test_fused_core_hashes_raw_lanes():
    """batch_verify_raw: raw-message lanes hash on the device path and
    mix with pre-digested lanes in one call."""
    from fabric_mod_tpu_torch.bccsp import der, sw
    key = sw.PrivateKey.from_seed(b"fused")
    msgs = [b"first message", b"", b"z" * 700]
    import hashlib
    digests = [hashlib.sha256(m).digest() for m in msgs]
    sigs = [sw.decode_dss_signature(key.sign(h)) for h in digests]
    n = len(msgs)
    d = np.zeros((n, 32), np.uint8)
    d[2] = np.frombuffer(digests[2], np.uint8)          # lane 2 pre-digested
    r = np.stack([np.frombuffer(a.to_bytes(32, "big"), np.uint8) for a, _ in sigs])
    s = np.stack([np.frombuffer(b.to_bytes(32, "big"), np.uint8) for _, b in sigs])
    xy = key.public_xy()
    qx = np.stack([np.frombuffer(xy[:32], np.uint8)] * n)
    qy = np.stack([np.frombuffer(xy[32:], np.uint8)] * n)
    words, nb, _ = der.pack_messages(msgs)
    has_msg = np.array([True, True, False])
    nb = np.where(has_msg, nb, 0)
    got = tp.batch_verify_raw(words, nb, has_msg, d, r, s, qx, qy,
                              device="cpu")
    assert got.tolist() == [True, True, True]


def test_entry_points_need_a_device_choice():
    """Without CUDA, an entry point not told to use the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    d, r, s, qx, qy, _ = fixtures.signature_arrays(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.batch_verify(d, r, s, qx, qy)
