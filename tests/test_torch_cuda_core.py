"""The verify core's CUDA kernels (fabric_mod_tpu_torch/csrc/p256_core.cu:
the prologue and the epilogue around the ladder), held on this CPU: the
per-lane code is plain C++ outside `__CUDACC__`, so g++ builds it
(tests/_torch_core_shim.py) and it is compared with Python ints and
with the plain PyTorch prologue and epilogue (ops/p256_core.py
prologue_plain / epilogue_plain).  The card's own runs of the kernels
are the `cuda` tests in tests/test_torch_cuda.py."""
import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fabric_mod_tpu_torch.ops import p256, p256_core, p256_cuda
from fabric_mod_tpu_torch.utils import fixtures
from tests import _torch_core_shim as shim

N, P = p256.N, p256.P
R256 = 1 << 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain limb code is many small ops: one intra-op thread a
    worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def core_lib(tmp_path_factory):
    lib = shim.build(tmp_path_factory.mktemp("core_shim"))
    if lib is None:
        pytest.skip("no host C++ compiler")
    return lib


def _words(vals):
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                     for v in vals], np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * k) for k, w in enumerate(row))
            for row in words.astype(object)]


def _fn_ops(lib, op, a, b):
    a, b = _words(a), _words(b)
    out = np.zeros_like(a)
    lib.fn_ops(op, a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a))
    return _ints(out)


def test_mod_n_product_on_host_compiler(core_lib):
    """fn_mul (CIOS mod n) against Python ints on edge and random
    operands within its contract: a any 256-bit value (a digest may be
    >= n), b < n; the result is fully reduced."""
    edges_b = [0, 1, 2, N - 1, N - 2, R256 % N, (1 << 255) % N]
    edges_a = edges_b + [N, N + 1, R256 - 1, R256 - 2, P, P - 1]
    rng = random.Random(5)
    pairs = [(a, b) for a in edges_a for b in edges_b]
    pairs += [(rng.randrange(R256), rng.randrange(N)) for _ in range(300)]
    got = _fn_ops(core_lib, 0, [a for a, _ in pairs], [b for _, b in pairs])
    rinv = pow(R256, -1, N)
    for (a, b), g in zip(pairs, got):
        assert g == a * b * rinv % N, (hex(a), hex(b))


def test_mod_n_inverse_on_host_compiler(core_lib):
    """fn_inv: a^(n-2) in the Montgomery domain (a -> a^-1 * R^2 in
    plain terms), and 0 -> 0 without trapping (padding lanes)."""
    rng = random.Random(6)
    vals = [0, 1, 2, N - 1, R256 % N] + [rng.randrange(1, N)
                                          for _ in range(40)]
    got = _fn_ops(core_lib, 1, vals, [0] * len(vals))
    for a, g in zip(vals, got):
        # a is a Montgomery value a = x R; the inverse is x^-1 R
        want = 0 if a == 0 else pow(a * pow(R256, -1, N), -1, N) * R256 % N
        assert g == want, hex(a)


def _most_divsteps(count: int, seed: int) -> int:
    """The value of `count` seeded ones in [1, n) whose inversion takes
    the most divsteps."""
    rng = random.Random(seed)
    return max((rng.randrange(1, N) for _ in range(count)),
               key=p256_core.divsteps)


def test_divstep_inverse_edges_on_host_compiler(core_lib):
    """fn_inv_plain (safegcd by batches of 30 divsteps) against pow(a, -1,
    n) on the edges 0, 1, 2, n-1, n-2, (n-1)/2, R mod n, every 2^k mod n,
    and the value with the most divsteps of 2000 seeded ones; that one
    needs more batches than the typical value and stays within the 741
    divsteps the loop's 25 batches allow."""
    worst = _most_divsteps(2000, 8)
    assert 19 * 30 > p256_core.divsteps(worst) > 530
    vals = [0, 1, 2, N - 1, N - 2, (N - 1) // 2, R256 % N, worst]
    vals += [pow(2, k, N) for k in range(256)]
    assert max(p256_core.divsteps(v) for v in vals) <= 741
    got = _fn_ops(core_lib, 2, vals, [0] * len(vals))
    for a, g in zip(vals, got):
        assert g == (pow(a, -1, N) if a else 0), hex(a)


@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=0, max_value=N - 1))
def test_divstep_inverse_property_on_host_compiler(core_lib, a):
    """fn_inv_plain(a) == pow(a, -1, n) (0 -> 0) over [0, n)."""
    assert _fn_ops(core_lib, 2, [a], [0]) == [pow(a, -1, N) if a else 0]


def _packed(planes, pre_ok):
    _, range_ok, rn_lt_p = p256.range_checks(*planes)
    return p256_core.pack(planes, range_ok, pre_ok, rn_lt_p)


@pytest.mark.parametrize("mixed", [False, True], ids=["projective", "mixed"])
def test_core_lanes_equal_plain_on_host_compiler(core_lib, mixed):
    """At width 13 (every edge lane of fixtures.make_core_lanes: digests
    >= n, padding, invalid keys, out-of-range scalars, a host-masked
    lane): the prologue lanes' window planes and key_ok are bit-equal to
    the plain prologue's; over the same ladder output the epilogue
    lanes' verdicts equal the plain epilogue's and the construction's."""
    planes, pre_ok, expect = fixtures.make_core_lanes(13)
    packed = _packed(planes, pre_ok)
    ok, (u1, u2, key_ok), (X, Z) = shim.run_core(core_lib, packed, mixed)
    buf = torch.from_numpy(packed)
    want = p256_core.prologue_plain(p256_core.rows(buf, p256_core.ROW_E), buf)
    assert torch.equal(u1, want[0])
    assert torch.equal(u2, want[1])
    assert torch.equal(key_ok, want[2])
    assert key_ok.tolist() == [True] * 6 + [False, False, False, True,
                                            False, True, True]
    plain = p256_core.epilogue_plain(X, Z, buf, key_ok)
    assert ok.tolist() == plain.tolist() == expect.tolist()


def test_epilogue_lanes_take_r_plus_n_only_where_it_is_below_p(core_lib):
    """Crafted ladder outputs: X == (r + n) Z is accepted where rn_lt_p
    holds and refused where it does not; X == r Z is accepted; Z = 0 is
    refused; the host masks each refuse a lane; the plain epilogue
    agrees on every lane."""
    rng = random.Random(7)
    n = 8
    r = [5, 5, rng.randrange(1, N), 7, 9, 11, 13, 15]
    z = [rng.randrange(1, P) for _ in range(n)]
    z[3] = 0
    x = [(ri + N) * zi % P for ri, zi in zip(r, z)]
    x[2] = r[2] * z[2] % P                           # X == r Z
    x[7] = r[7] * z[7] % P
    planes = [np.zeros((n, 32), np.uint8) for _ in range(5)]
    for i, ri in enumerate(r):
        planes[1][i] = np.frombuffer(ri.to_bytes(32, "big"), np.uint8)
        planes[2][i, 31] = 1                         # s = 1: in range
    range_ok = np.ones(n, bool)
    range_ok[4] = False
    pre_ok = np.ones(n, bool)
    pre_ok[5] = False
    rn_lt_p = np.array([True, False, True, True, True, True, True, True])
    key_ok = torch.tensor([True] * 6 + [False, True])
    packed = p256_core.pack(planes, range_ok, pre_ok, rn_lt_p)
    X = _words(x).T.view(np.int32).copy()
    Z = _words(z).T.view(np.int32).copy()
    got = shim.epilogue(core_lib, X, Z, packed, key_ok)
    want = p256_core.epilogue_plain(torch.from_numpy(X), torch.from_numpy(Z),
                                    torch.from_numpy(packed), key_ok)
    assert got.tolist() == want.tolist() == [True, False, True, False,
                                             False, False, False, True]


def test_pack_layout():
    """The packed buffer: little-endian words of each plane in their
    rows, the flags in the last row — what p256_cuda.from_u32_bits and
    the kernels read back."""
    planes, pre_ok, _ = fixtures.make_core_lanes(13)
    _, range_ok, rn_lt_p = p256.range_checks(*planes)
    packed = torch.from_numpy(p256_core.pack(planes, range_ok, pre_ok, rn_lt_p))
    assert packed.shape == (p256_core.ROWS, 13)
    for row, plane in zip((p256_core.ROW_E, p256_core.ROW_R, p256_core.ROW_S,
                           p256_core.ROW_QX, p256_core.ROW_QY), planes):
        words = p256_cuda.from_u32_bits(p256_core.rows(packed, row))
        got = [sum(int(words[k, i]) << (32 * k) for k in range(8))
               for i in range(13)]
        assert got == [int.from_bytes(bytes(b), "big") for b in plane]
    assert p256_core.flag(packed, p256_core.FLAG_RANGE_OK).tolist() == \
        range_ok.tolist()
    assert p256_core.flag(packed, p256_core.FLAG_PRE_OK).tolist() == \
        pre_ok.tolist()
    assert p256_core.flag(packed, p256_core.FLAG_RN_LT_P).tolist() == \
        rn_lt_p.tolist()
    assert not p256_core.has_msg(packed).any()


def _windows(u: int):
    return [(u >> (4 * (63 - w))) & 15 for w in range(64)]


def test_group_ranks_in_turn_equal_the_lane_on_host_compiler(core_lib):
    """The prologue's thread group run rank by rank on the host (rank 0
    the inversion and u1, rank 1 the key check and u2) gives every lane
    the windows and key_ok that one thread computing the whole lane
    gives, here in Python ints: u1 = e s^-1, u2 = r s^-1 mod n (s^-1 of
    s = 0 mod n taken as 0), key_ok = on the curve mod p and not (0, 0).
    Lanes: every edge lane of fixtures.make_core_lanes (digests >= n,
    padding, invalid keys, s = 2^256 - 1) and one more with s = n."""
    planes, pre_ok, _ = fixtures.make_core_lanes(16)
    planes[2][13] = np.frombuffer(N.to_bytes(32, "big"), np.uint8)
    packed = _packed(planes, pre_ok)
    u1, u2, key_ok = shim.prologue(core_lib, packed[p256_core.ROW_E:
                                                   p256_core.ROW_E + 8], packed)
    e, r, s_, qx, qy = ([int.from_bytes(bytes(b), "big") for b in plane]
                        for plane in planes)
    for i in range(16):
        w = pow(s_[i] % N, -1, N) if s_[i] % N else 0
        assert u1[:, i].tolist() == _windows(e[i] * w % N), i
        assert u2[:, i].tolist() == _windows(r[i] * w % N), i
        x, y = qx[i] % P, qy[i] % P
        on = (y * y - x ** 3 + 3 * x - p256.B) % P == 0
        assert bool(key_ok[i]) == (on and (x, y) != (0, 0)), i
    assert u1[:, 13].tolist() == u2[:, 13].tolist() == [0] * 64


def test_epilogue_three_products_against_ints_on_host_compiler(core_lib):
    """The epilogue's r' Z R^-1 == X R^-1 form against Python ints on
    random lanes, with r + n below p, at or above p, and wrapping past
    2^256: X == r Z, X == (r + n) Z (accepted only where r + n < p), or
    random X; Z = 0 refused."""
    rng = random.Random(9)
    n = 64
    r = [rng.choice([rng.randrange(1, P - N), rng.randrange(P - N, N),
                     rng.randrange(R256 - N, N)]) for _ in range(n)]
    r[:3] = [P - N - 1, P - N, R256 - N]
    z = [rng.randrange(1, P) for _ in range(n)]
    z[5] = 0
    x = []
    for i, (ri, zi) in enumerate(zip(r, z)):
        kind = i % 3
        x.append(ri * zi % P if kind == 0 else (ri + N) * zi % P if kind == 1
                 else rng.randrange(P))
    rn_lt_p = np.array([ri + N < P for ri in r])
    planes = [np.zeros((n, 32), np.uint8) for _ in range(5)]
    for i, ri in enumerate(r):
        planes[1][i] = np.frombuffer(ri.to_bytes(32, "big"), np.uint8)
    ones = np.ones(n, bool)
    packed = p256_core.pack(planes, ones, ones, rn_lt_p)
    X = _words(x).T.view(np.int32).copy()
    Z = _words(z).T.view(np.int32).copy()
    got = shim.epilogue(core_lib, X, Z, packed, torch.ones(n, dtype=torch.bool))
    want = [zi != 0 and (xi == ri * zi % P
                         or (ri + N < P and xi == (ri + N) * zi % P))
            for ri, zi, xi in zip(r, z, x)]
    assert got.tolist() == want
    assert any(want) and not all(want)
    assert not any(rn_lt_p[1:3]) and rn_lt_p[0]
