"""The idemix pairing kernels (fabric_mod_tpu_torch/csrc/fp256bn_pairing.cu
and fp256bn_field.cuh) compiled by the host C++ compiler
(tests/_torch_fp256bn_shim.py), on the CPU.

Every case is exact: integers, no tolerance.  The field operations are
held against Python ints (seeded values and the edges 0, 1, p - 1 and
R mod p); each tower operation against the JAX reference's
(fabric_mod_tpu/ops/fp256bn_dev.py, run eagerly on the same seeded numpy
inputs), coefficient by coefficient as canonical ints (the reference
works in Montgomery form with R = 2^270, the kernels with R = 2^256); the
kernels' Miller lanes and full pairings against the pinned reference
vectors (tests/_fixtures/fp256bn_pairing_vectors.json, read only); the
check lanes against the plain `pairing_check_batch(device="cpu")`; and
the shim's count of Fp products against `fp256bn_cuda.products_per_lane`,
which the chip run's bound is computed from."""
import json
import os
import random
import re

import numpy as np
import pytest
import torch

from fabric_mod_tpu.ops import fp256bn_dev as J
from fabric_mod_tpu_torch.idemix import fp256bn as host
from fabric_mod_tpu_torch.ops import fp256bn_cuda as C
from fabric_mod_tpu_torch.ops import fp256bn_dev as T
from fabric_mod_tpu_torch.ops import limbs9
from fabric_mod_tpu_torch.utils import fixtures
from tests import _torch_fp256bn_shim as shim
from tests._torch_fp256bn_planes import BATCH, P, _planes, j2, j6, j12, jleaves

R256 = 1 << 256
R256_INV = pow(R256, -1, P)
R270_INV = pow(1 << 270, -1, P)
_VEC_PATH = os.path.join(os.path.dirname(__file__), "_fixtures",
                         "fp256bn_pairing_vectors.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    built = shim.build(tmp_path_factory.mktemp("fp256bn_shim"))
    if built is None:
        pytest.skip("no host C++ compiler (g++) to build the kernels' "
                    "lanes")
    return built


@pytest.fixture(scope="module")
def pinned():
    with open(_VEC_PATH) as fh:
        data = json.load(fh)
    pts = data["points"]
    w = int(pts["w"], 16)
    g2 = host.g2_generator()

    def fp12_of(vals):
        v = [int(s, 16) for s in vals]
        return _fp12([v[c] for c in range(12)])
    return {
        "g2": g2, "w": w, "W": host.g2_mul(w, g2),
        "P": [host.G1(*(int(v, 16) for v in pts[k])) for k in ("P1", "P2")],
        "miller": [fp12_of(f) for f in data["miller"]],
        "pairing": [fp12_of(f) for f in data["pairing"]],
    }


def _fp12(v):
    """12 ints, coefficient c = 6h + 2i + j -> host.Fp12."""
    def fp6(o):
        return host.Fp6(host.Fp2(v[o], v[o + 1]), host.Fp2(v[o + 2], v[o + 3]),
                        host.Fp2(v[o + 4], v[o + 5]))
    return host.Fp12(fp6(0), fp6(6))


def _planes_fp12(planes: np.ndarray, lane: int) -> "host.Fp12":
    """The lane's host Fp12 of (12, 8, n) canonical word planes."""
    return _fp12([shim.ints(planes[c][:, lane])[0] for c in range(12)])


# --- (0) the source's constants ---------------------------------------------

def _words_of(name: str) -> int:
    text = shim.SRC.with_name("fp256bn_field.cuh").read_text()
    body = re.search(name + r"\[8\] = \{([^}]*)\}", text).group(1)
    ws = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9A-F]+u", body)]
    return sum(w << (32 * k) for k, w in enumerate(ws))


def test_field_constants():
    assert _words_of("kBnP") == P == T.host.P
    assert _words_of("kBnPm2") == P - 2
    assert _words_of("kBnR2") == R256 * R256 % P
    assert _words_of("kBnOneM") == R256 % P
    text = shim.SRC.with_name("fp256bn_field.cuh").read_text()
    assert int(re.search(r"kBnP0Inv = (0x[0-9A-F]+)u", text).group(1),
               16) == (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert int(re.search(r"kBnAbsU = (0x[0-9A-F]+)ull", text).group(1),
               16) == abs(host.U)


# --- (1) the field ---------------------------------------------------------------

_EDGES = [0, 1, P - 1, R256 % P]


def _field_operands():
    rng = random.Random(16)
    a = [rng.randrange(P) for _ in range(40)] + _EDGES * 4
    b = [rng.randrange(P) for _ in range(40)] + [e for e in _EDGES
                                                for _ in range(4)]
    return a, b


_FIELD = {
    "mul": (shim.FP_MUL, lambda a, b: a * b * R256_INV % P),
    "sqr": (shim.FP_SQR, lambda a, b: a * a * R256_INV % P),
    "add": (shim.FP_ADD, lambda a, b: (a + b) % P),
    "sub": (shim.FP_SUB, lambda a, b: (a - b) % P),
    "neg": (shim.FP_NEG, lambda a, b: -a % P),
    # the inverse in the Montgomery domain: (a/R)^-1 * R; 0 maps to 0
    "inv": (shim.FP_INV,
            lambda a, b: pow(a * R256_INV, -1, P) * R256 % P if a else 0),
    "to_mont": (shim.FP_TO_MONT, lambda a, b: a * R256 % P),
    "from_mont": (shim.FP_FROM_MONT, lambda a, b: a * R256_INV % P),
}


@pytest.mark.parametrize("op", sorted(_FIELD))
def test_field_op_against_ints(lib, op):
    code, want = _FIELD[op]
    a, b = _field_operands()
    got = shim.fp_ops(lib, code, a, b)
    assert got == [want(x, y) for x, y in zip(a, b)]
    assert all(v < P for v in got)


# --- (2) the tower against the JAX reference --------------------------------------

def _ref_ints(planes) -> list:
    """Reference limb planes (n, K, BATCH), lazy or not -> [leaf][lane]
    canonical ints."""
    return [[limbs9.limbs_to_int(np.asarray(leaf)[:, b]) * R270_INV % P
             for b in range(BATCH)] for leaf in planes]


def _records(*groups) -> np.ndarray:
    """Leaves of (n, K, BATCH) planes, concatenated -> (BATCH, 96) shim
    records of their kernel-domain (R = 2^256) words."""
    leaves = [v for g in groups for v in _ref_ints(g)]
    rec = np.zeros((BATCH, 96), np.uint32)
    for c, vals in enumerate(leaves):
        rec[:, 8 * c:8 * c + 8] = shim.words([v * R256 % P for v in vals])
    return rec


def _record_ints(rec: np.ndarray, n_leaves: int) -> list:
    """(BATCH, 96) shim records -> [leaf][lane] canonical ints."""
    return [[v * R256_INV % P for v in shim.ints(rec[:, 8 * c:8 * c + 8])]
            for c in range(n_leaves)]


def _tower_cases():
    rng = random.Random(161)
    x2, y2 = _planes(rng, 2), _planes(rng, 2)
    x6, y6 = _planes(rng, 6), _planes(rng, 6)
    x12, y12 = _planes(rng, 12), _planes(rng, 12)
    yp, A, B = _planes(rng, 1), _planes(rng, 2), _planes(rng, 2)
    return {
        "f2_mul": (shim.F2_MUL, (x2,), (y2,), 2,
                   lambda: J.f2_mul(j2(x2), j2(y2))),
        "f2_sqr": (shim.F2_SQR, (x2,), None, 2, lambda: J.f2_sqr(j2(x2))),
        "f2_inv": (shim.F2_INV, (x2,), None, 2, lambda: J.f2_inv(j2(x2))),
        "f6_mul": (shim.F6_MUL, (x6,), (y6,), 6,
                   lambda: J.f6_mul(j6(x6), j6(y6))),
        "f6_mul_sparse12": (shim.F6_MUL_SPARSE12, (x6,), (A, B), 6,
                            lambda: J.f6_mul_sparse12(j6(x6), j2(A), j2(B))),
        "f12_mul": (shim.F12_MUL, (x12,), (y12,), 12,
                    lambda: J.f12_mul(j12(x12), j12(y12))),
        "f12_sqr": (shim.F12_SQR, (x12,), None, 12,
                    lambda: J.f12_sqr(j12(x12))),
        "f12_mul_line": (shim.F12_MUL_LINE, (x12,), (yp, A, B), 12,
                         lambda: J.f12_mul_line(j12(x12), yp[0], j2(A),
                                                j2(B))),
        "f12_frobenius": (shim.F12_FROBENIUS, (x12,), None, 12,
                          lambda: J.f12_frobenius(j12(x12))),
        "f12_inv": (shim.F12_INV, (x12,), None, 12,
                    lambda: J.f12_inv(j12(x12))),
    }


_TOWER = sorted(_tower_cases())


@pytest.mark.parametrize("op", _TOWER)
def test_tower_op_against_reference(lib, op):
    code, xs, ys, n_out, ref = _tower_cases()[op]
    got = shim.tower_ops(lib, code, _records(*xs),
                         None if ys is None else _records(*ys))
    want = _ref_ints(jleaves(ref()))
    assert len(want) == n_out
    assert _record_ints(got, n_out) == want


# --- (3) the kernels' lanes against the pinned vectors -----------------------------

def _miller_inputs(points, q):
    sched = T.line_schedule(q)
    return (C.point_words(points)[None], sched.line_words()[None],
            sched.is_add.astype(np.int32))


def test_line_words_are_the_schedule(pinned):
    """The kernels' line constants are the limb schedule's values."""
    sched = T.line_schedule(pinned["W"])
    words = sched.line_words()
    assert words.shape == (len(sched.is_add) + 2, 4, 8)
    A = np.concatenate([sched.A, sched.corr_A])
    B = np.concatenate([sched.B, sched.corr_B])
    for s in (0, 7, len(words) - 1):
        for q, limb in enumerate((A[s, 0], A[s, 1], B[s, 0], B[s, 1])):
            want = limbs9.limbs_to_int(limb) * R270_INV % P
            assert shim.ints(words[s, q])[0] == want


def test_miller_lanes_match_pinned_vectors(lib, pinned):
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    out = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32), is_add)
    for i in range(2):
        assert _planes_fp12(out[0], i) == pinned["miller"][i]


def test_pairing_lanes_match_pinned_vectors(lib, pinned):
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    f = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32), is_add)
    out = shim.final_exp(lib, f, check=False)
    for i in range(2):
        assert _planes_fp12(out, i) == pinned["pairing"][i]


def test_plain_versions_equal_the_lanes(lib, pinned):
    """On CPU tensors the kernels' wrappers are the plain versions: the
    same words as the host-compiled lanes, and no launch counted."""
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    C.reset_counts()
    f = C.miller(torch.from_numpy(pts), torch.from_numpy(lines),
                 torch.from_numpy(is_add))
    lanes = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32),
                        is_add)
    assert np.array_equal(f.numpy().view(np.uint32), lanes)
    out = C.final_exp(f, check=False)
    assert np.array_equal(out.numpy().view(np.uint32),
                          shim.final_exp(lib, lanes, check=False))
    assert C.counts() == {name: 0 for name in C.KERNELS}
    g = C.f12_from_words(out)
    for i in range(2):
        assert T.f12_to_host(g, i) == pinned["pairing"][i]


# --- (4) the check -------------------------------------------------------------------

def _check_lanes(lib, a_points, q1, b_points, q2):
    s1, s2 = T.line_schedule(q1), T.line_schedule(q2)
    pts = np.stack([C.point_words(a_points), C.point_words(b_points)])
    lines = np.stack([s1.line_words(), s2.line_words()])
    f = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32),
                    s1.is_add.astype(np.int32))
    return shim.final_exp(lib, f, check=True)


def test_check_ver_shaped(lib, pinned):
    """e(A, W) == e(w·A, g2), and not for w·A + G: [True, False], as the
    plain check on the CPU gives."""
    A = pinned["P"][0]
    Abar = host.g1_mul(pinned["w"], A)
    bad = host.g1_add(Abar, host.G1.generator())
    args = ([A, A], pinned["W"], [Abar.neg(), bad.neg()], pinned["g2"])
    got = _check_lanes(lib, *args)
    assert got.tolist() == [True, False]
    assert got.tolist() == T.pairing_check_batch(*args, device="cpu").tolist()


def test_check_tampered_lanes_equal_plain(lib):
    world = fixtures.make_idemix_world(seed=5, n_users=1)
    a, abar, expect = fixtures.make_pairing_lanes(world, 6, tamper_every=3,
                                                  seed=5)
    ik = world.issuer.key
    args = (a, ik.W, [p.neg() for p in abar], ik.g2)
    got = _check_lanes(lib, *args)
    assert got.tolist() == expect.tolist() == [True, True, False] * 2
    assert got.tolist() == T.pairing_check_batch(*args, device="cpu").tolist()


# --- (5) the work a lane needs --------------------------------------------------------

def test_products_per_lane(lib, pinned):
    """The shim's count of Fp products equals products_per_lane (the
    Miller lanes plus each schedule's conversion, 4 a step), the count
    the chip run's bound rests on."""
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    pts2, lines2 = np.concatenate([pts, pts]), np.concatenate([lines, lines])
    n, S, steps = pts.shape[-1], 2, lines.shape[1]
    lib.products()
    f = shim.miller(lib, pts2.view(np.uint32), lines2.view(np.uint32), is_add)
    miller = C.products_per_lane(is_add, "fp256bn_miller")
    assert lib.products() == S * (n * miller + C.LINE_VALUES * steps)
    shim.final_exp(lib, f, check=True)
    check = C.products_per_lane(is_add, "fp256bn_final_exp", check=True)
    assert lib.products() == n * check
    shim.final_exp(lib, f[:1], check=False)
    assert lib.products() == n * C.products_per_lane(
        is_add, "fp256bn_final_exp", check=False)
    # one lane of a check: both Miller loops and the final exponentiation
    assert 2 * miller + check == 24_606
