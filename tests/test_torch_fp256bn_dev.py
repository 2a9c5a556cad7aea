"""The port's batched pairing (fabric_mod_tpu_torch/ops/fp256bn_dev.py) against
the JAX reference (fabric_mod_tpu/ops/fp256bn_dev.py) on the CPU.

Each tower operation gets the same seeded numpy inputs in both packages
(the reference run eagerly, as its own tests run it) and must give limb
planes equal with np.array_equal: the port stacks independent products
and adds but keeps each element's sequence of limb operations.  The
Miller loop and the full pairing are held against the persisted
reference vectors (tests/_fixtures/fp256bn_pairing_vectors.json, read
only), and one full pairing check against the Ver-shaped pair of the
reference's slow test.  The Fp12 operations are in
test_torch_fp256bn_f12.py."""
import json
import os
import random

import numpy as np
import pytest
import torch

from fabric_mod_tpu.idemix import fp256bn as Jhost
from fabric_mod_tpu.ops import fp256bn_dev as J
from fabric_mod_tpu_torch.idemix import fp256bn as host
from fabric_mod_tpu_torch.ops import fp256bn_dev as T
from tests._torch_fp256bn_planes import (
    P, _planes, assert_planes_equal, j2, j6, j12, leaves2, leaves6, leaves12,
    t2, t6, t12)

_VEC_PATH = os.path.join(os.path.dirname(__file__), "_fixtures",
                         "fp256bn_pairing_vectors.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- tower operations --------------------------------------------------------

def test_fp2_ops_bit_equal():
    rng = random.Random(21)
    a, b, s = _planes(rng, 2), _planes(rng, 2), _planes(rng, 1)[0]
    assert_planes_equal(leaves2(T.f2_mul(t2(a), t2(b))), J.f2_mul(j2(a), j2(b)))
    assert_planes_equal(leaves2(T.f2_sqr(t2(a))), J.f2_sqr(j2(a)))
    assert_planes_equal(leaves2(T.f2_inv(t2(a))), J.f2_inv(j2(a)))
    assert_planes_equal(leaves2(T.f2_mul_xi(t2(a))), J.f2_mul_xi(j2(a)))
    assert_planes_equal(leaves2(T.f2_conj(t2(a))), J.f2_conj(j2(a)))
    assert_planes_equal(leaves2(T.f2_mul_fp(t2(a), torch.from_numpy(s))),
                        J.f2_mul_fp(j2(a), s))


def test_fp6_ops_bit_equal():
    rng = random.Random(22)
    x, y, b = _planes(rng, 6), _planes(rng, 6), _planes(rng, 4)
    assert_planes_equal(leaves6(T.f6_mul(t6(x), t6(y))), J.f6_mul(j6(x), j6(y)))
    assert_planes_equal(leaves6(T.f6_inv(t6(x))), J.f6_inv(j6(x)))
    assert_planes_equal(
        leaves6(T.f6_mul_sparse12(t6(x), t2(b[:2]), t2(b[2:]))),
        J.f6_mul_sparse12(j6(x), j2(b[:2]), j2(b[2:])))


def test_line_multiply_bit_equal():
    """The sparse line multiply with bare (K,) line constants A, as the
    Miller loop uses them, and per-lane B·xP and yP."""
    rng = random.Random(24)
    f, bxp, yp = _planes(rng, 12), _planes(rng, 2), _planes(rng, 1)[0]
    A = T._mont_fp2_np(host.Fp2(rng.randrange(P), rng.randrange(P)))
    got = T.f12_mul_line(t12(f), torch.from_numpy(yp),
                         torch.from_numpy(A.T.copy()), t2(bxp))
    want = J.f12_mul_line(j12(f), yp, (A[0], A[1]), j2(bxp))
    assert_planes_equal(leaves12(got), want)


# --- the pairing --------------------------------------------------------------

def _fp12_of(vals):
    v = [int(s, 16) for s in vals]

    def fp6(o):
        return host.Fp6(host.Fp2(v[o], v[o + 1]), host.Fp2(v[o + 2], v[o + 3]),
                        host.Fp2(v[o + 4], v[o + 5]))
    return host.Fp12(fp6(0), fp6(6))


@pytest.fixture(scope="module")
def pinned():
    with open(_VEC_PATH) as fh:
        data = json.load(fh)
    pts = data["points"]
    w = int(pts["w"], 16)
    g2 = host.g2_generator()
    return {
        "g2": g2, "w": w, "W": host.g2_mul(w, g2),
        "P": [host.G1(*(int(v, 16) for v in pts[k])) for k in ("P1", "P2")],
        "miller": [_fp12_of(f) for f in data["miller"]],
        "pairing": [_fp12_of(f) for f in data["pairing"]],
    }


@pytest.fixture(scope="module")
def miller_out(pinned):
    xs, ys = T._g1_batch_to_mont(pinned["P"], torch.device("cpu"))
    return T.miller_batch(xs, ys, T.line_schedule(pinned["W"]))


def test_line_schedule_bit_equal(pinned):
    """The host-built schedules of g2 and of a seeded W, array by array."""
    for q in (pinned["g2"], host.g2_mul(random.Random(25).randrange(host.R),
                                        pinned["g2"])):
        qj = Jhost.G2(Jhost.Fp2(q.x.a, q.x.b), Jhost.Fp2(q.y.a, q.y.b))
        got, want = T.line_schedule(q), J.line_schedule(qj)
        for name in ("is_add", "A", "B", "corr_A", "corr_B"):
            assert np.array_equal(getattr(got, name), getattr(want, name)), name
        assert T.line_schedule(q) is got          # cached per point


def test_miller_matches_pinned_vectors(pinned, miller_out):
    for i in range(2):
        assert T.f12_to_host(miller_out, i) == pinned["miller"][i]


def test_final_exp_easy_part_matches_host(pinned, miller_out):
    f = T._easy_part(miller_out)
    for i in range(2):
        m = pinned["miller"][i]
        want = m.conj() * m.inv()
        assert T.f12_to_host(f, i) == want.frobenius().frobenius() * want


def test_pairing_batch_matches_pinned_vectors(pinned):
    got = T.pairing_batch(pinned["P"], pinned["W"], device="cpu")
    for i in range(2):
        assert T.f12_to_host(got, i) == pinned["pairing"][i]


def test_pairing_check_ver_shaped(pinned):
    """e(A, W) == e(w·A, g2), and not for w·A + G — the reference's slow
    test, here in tier-1."""
    A = pinned["P"][0]
    Abar = host.g1_mul(pinned["w"], A)
    bad = host.g1_add(Abar, host.G1.generator())
    T.reset_counts()
    ok = T.pairing_check_batch([A, A], pinned["W"], [Abar.neg(), bad.neg()],
                               pinned["g2"], device="cpu")
    assert ok.tolist() == [True, False]
    assert T.counts() == {"cpu": 1}


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    g2 = host.g2_generator()
    with pytest.raises(RuntimeError):
        T.pairing_check_batch([host.G1.generator()], g2,
                              [host.G1.generator()], g2)
    with pytest.raises(RuntimeError):
        T.pairing_batch([host.G1.generator()], g2)
