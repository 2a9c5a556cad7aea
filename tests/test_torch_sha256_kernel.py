"""The SHA-256 kernel (fabric_mod_tpu_torch/csrc/sha256.cu) held on this
CPU: its per-lane code is plain C++ outside `__CUDACC__`, so g++ builds
it (tests/_torch_sha256_shim.py), composing the producers' schedule and
the consumer's rounds through the kernel's shared-memory ring, and it is
compared with hashlib, with the plain PyTorch version
(ops/sha256.sha256_e_plain over sha256_blocks) and with the JAX
reference's sha256_blocks, digest by digest in the verify core's packed
buffer.  The CPU route of the raw verify path (ops/p256.batch_verify_raw)
goes through the same plain version.  The card's own runs of the kernel
are the `cuda` tests in tests/test_torch_cuda.py."""
import hashlib
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fabric_mod_tpu.ops import sha256 as jsha
from fabric_mod_tpu_torch.bccsp import der
from fabric_mod_tpu_torch.ops import p256_core, sha256
from tests import _torch_sha256_shim as shim

EDGE_LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120]
# the ring test's input sets: message lengths in bytes, and the lanes
# whose nblocks is set out of range (_ring_inputs)
_rng = random.Random(14)
RING_CASES = {
    # 3000 bytes: 48 blocks, far more than the ring's 4 slots
    "edge_and_long_lengths": ([0, 1, 55, 56, 63, 64, 119, 120, 1000, 3000],
                              ()),
    # 4, 5 and 9 blocks: the ring full, wrapped once, wrapped twice
    "ring_wraps": ([247, 311, 567, 0, 3000], ()),
    # one thread block of 16 lanes of different lengths
    "mixed_lengths_in_one_block": ([_rng.randrange(3001) for _ in range(16)],
                                   ()),
    # a second thread block: 5 lanes, its other 11 past the batch
    "two_thread_blocks": ([_rng.randrange(701) for _ in range(21)], ()),
    "nblocks_out_of_range": ([200, 200, 200, 900, 10, 0], (0, 1, 2)),
    # the width of an MCS check
    "one_lane": ([1000], ()),
}


@pytest.fixture(scope="module")
def sha_lib(tmp_path_factory):
    lib = shim.build(tmp_path_factory.mktemp("sha256_shim"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def _packed(n, has_msg, seed=3):
    """A (ROWS, n) int32 buffer with random words and FLAG_HAS_MSG set
    where `has_msg` says (plus unrelated flag bits)."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2**31, 2**31, (p256_core.ROWS, n), dtype=np.int64)
    flags = rng.integers(0, 8, n) & ~p256_core.FLAG_HAS_MSG
    buf[p256_core.ROW_FLAGS] = flags | np.where(
        has_msg, p256_core.FLAG_HAS_MSG, 0)
    return buf.astype(np.int32)


def _e_digest(buf, lane) -> bytes:
    """The lane's e rows (little-endian words) as the big-endian digest."""
    words = buf[p256_core.ROW_E:p256_core.ROW_E + 8, lane].view(np.uint32)
    value = sum(int(w) << (32 * k) for k, w in enumerate(words))
    return value.to_bytes(32, "big")


def _plain(words, nblocks, buf):
    out = torch.from_numpy(buf.copy())
    sha256.sha256_e(torch.from_numpy(words.view(np.int32)),
                    torch.from_numpy(nblocks), out)
    return out.numpy()


def _round_pow2(words):
    """The plane padded with zero blocks to a power of two blocks (as the
    reference packs it): blocks past every lane's own nblocks."""
    out = np.zeros((words.shape[0], 1 << (words.shape[1] - 1).bit_length(),
                    16), np.uint32)
    out[:, :words.shape[1]] = words
    return out


def _check(lib, msgs, has_msg=None, round_pow2=True):
    n = len(msgs)
    has_msg = np.ones(n, bool) if has_msg is None else np.asarray(has_msg)
    words, nblocks, ok = der.pack_messages(msgs)
    assert ok.all()
    if round_pow2:
        words = _round_pow2(words)
    buf = _packed(n, has_msg)
    got = shim.sha256_e(lib, words, nblocks, buf)
    assert np.array_equal(got, _plain(words, nblocks, buf))
    for lane, m in enumerate(msgs):
        if has_msg[lane]:
            assert _e_digest(got, lane) == hashlib.sha256(m).digest()
        else:
            assert np.array_equal(got[:, lane], buf[:, lane])
    rest = np.ones(p256_core.ROWS, bool)
    rest[p256_core.ROW_E:p256_core.ROW_E + 8] = False
    assert np.array_equal(got[rest], buf[rest])      # only e rows move
    return got


def test_edge_and_long_lengths_match_hashlib_and_plain(sha_lib):
    rng = random.Random(8)
    lengths = EDGE_LENGTHS + [rng.randrange(1000, 3001) for _ in range(6)]
    _check(sha_lib, [rng.randbytes(n) for n in lengths])


def test_lanes_without_a_message_keep_their_e_rows(sha_lib):
    rng = random.Random(9)
    msgs = [rng.randbytes(n) for n in (3, 700, 64, 0, 1500, 56)]
    _check(sha_lib, msgs, has_msg=[True, False, True, False, False, True])


def test_a_lane_stops_at_its_own_nblocks(sha_lib):
    """Garbage words past a lane's nblocks change nothing; nblocks out of
    [0, max_blocks] clamp as the plain version's block loop does."""
    rng = random.Random(10)
    msgs = [rng.randbytes(n) for n in (10, 2000, 130, 500)]
    words, nblocks, _ok = der.pack_messages(msgs)
    buf = _packed(len(msgs), np.ones(len(msgs), bool))
    clean = shim.sha256_e(sha_lib, words, nblocks, buf)
    dirty = words.copy()
    for lane, nb in enumerate(nblocks):
        dirty[lane, nb:] = np.frombuffer(
            rng.randbytes(4 * 16 * (words.shape[1] - nb)), np.uint32
        ).reshape(-1, 16)
    assert np.array_equal(shim.sha256_e(sha_lib, dirty, nblocks, buf), clean)
    odd = nblocks.copy()
    odd[0], odd[2] = -3, words.shape[1] + 5
    got = shim.sha256_e(sha_lib, dirty, odd, buf)
    assert np.array_equal(got, _plain(dirty, odd, buf))
    h0 = sha256._H0
    assert [int(w) for w in got[:8, 0].view(np.uint32)] == \
        [int(v) for v in h0[::-1]]


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 400), min_size=1, max_size=6),
       st.randoms(use_true_random=False))
def test_hypothesis_lengths(sha_lib, lengths, rnd):
    _check(sha_lib, [rnd.randbytes(n) for n in lengths], round_pow2=False)


def test_cpu_raw_route_writes_the_digest_e_rows():
    """The raw verify path's CPU route: ops/sha256.sha256_e on CPU
    tensors is the plain version, in place, and counts no launch."""
    rng = random.Random(12)
    msgs = [rng.randbytes(n) for n in (0, 64, 900)]
    words, nblocks, _ok = der.pack_messages(msgs, rows=4)
    buf = _packed(4, np.array([True, True, True, False]))
    before = sha256.counts()
    t = torch.from_numpy(buf.copy())
    assert sha256.sha256_e(torch.from_numpy(words.view(np.int32)),
                           torch.from_numpy(nblocks), t) is t
    assert sha256.counts() == before
    for lane, m in enumerate(msgs):
        assert _e_digest(t.numpy(), lane) == hashlib.sha256(m).digest()
    assert np.array_equal(t.numpy()[:, 3], buf[:, 3])


def _ring_inputs(case):
    """RING_CASES[case] packed: words, nblocks (with the case's lanes set
    out of range: -3, max_blocks + 5, 2^31 - 1 in turn) and messages."""
    lengths, out_of_range = RING_CASES[case]
    rng = random.Random(sum(map(ord, case)))
    msgs = [rng.randbytes(n) for n in lengths]
    words, nblocks, ok = der.pack_messages(msgs)
    assert ok.all()
    nblocks = nblocks.copy()
    for lane, nb in zip(out_of_range, (-3, words.shape[1] + 5, 2**31 - 1)):
        nblocks[lane] = nb
    return words, nblocks, msgs


def _jax_digests(words, nblocks):
    """The JAX reference's sha256_blocks of the same numpy words, in
    batches of at most 16 lanes (int64 words)."""
    import jax.numpy as jnp
    out = [np.asarray(jsha.sha256_blocks(jnp.asarray(words[i:i + 16]),
                                         jnp.asarray(nblocks[i:i + 16])))
           for i in range(0, words.shape[0], 16)]
    return np.concatenate(out).astype(np.int64)


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_composition_matches_three_references(sha_lib, case):
    """The producer's schedule -> ring -> the consumer's rounds, composed
    as the kernel composes them in its thread blocks (each lane looping
    to its block's longest): equal to the JAX reference's sha256_blocks
    and the port's plain sha256_blocks on every lane (out-of-range
    nblocks clamped), and to hashlib on the in-range ones."""
    words, nblocks, msgs = _ring_inputs(case)
    want = _jax_digests(words, nblocks)
    plain = sha256.sha256_blocks(torch.from_numpy(words.astype(np.int64)),
                                 torch.from_numpy(nblocks.astype(np.int64)))
    assert np.array_equal(plain.numpy(), want)
    buf = _packed(len(msgs), np.ones(len(msgs), bool))
    got = shim.sha256_e(sha_lib, words, nblocks, buf)
    e_words = got[p256_core.ROW_E:p256_core.ROW_E + 8].view(np.uint32)
    assert np.array_equal(e_words.T[:, ::-1].astype(np.int64), want)
    assert np.array_equal(got, _plain(words, nblocks, buf))
    out_of_range = RING_CASES[case][1]
    for lane, m in enumerate(msgs):
        if lane not in out_of_range:
            assert _e_digest(got, lane) == hashlib.sha256(m).digest()
    if out_of_range:                       # nblocks -3: no block hashed
        assert [int(w) for w in e_words[::-1, out_of_range[0]]] == \
            [int(v) for v in sha256._H0]
