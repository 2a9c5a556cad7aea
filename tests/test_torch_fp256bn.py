"""The port's host FP256BN reference (fabric_mod_tpu_torch/idemix/fp256bn.py)
against the JAX package's (fabric_mod_tpu/idemix/fp256bn.py): constants,
generators, seeded random tower operations, the Miller loop and the
pairing on the seed-0x5EED points of tests/test_fp256bn_dev.py, whose
values are persisted in tests/_fixtures/fp256bn_pairing_vectors.json
(read here, never written).  Every comparison is exact."""
import json
import os
import random

import pytest

from fabric_mod_tpu.idemix import fp256bn as J
from fabric_mod_tpu_torch.idemix import fp256bn as T

_VEC_PATH = os.path.join(os.path.dirname(__file__), "_fixtures",
                         "fp256bn_pairing_vectors.json")


def _ints12(x):
    return [v for c in (x.c0, x.c1) for f2 in (c.c0, c.c1, c.c2)
            for v in (f2.a, f2.b)]


def _t12(vals):
    v = list(vals)

    def fp6(o):
        return T.Fp6(T.Fp2(v[o], v[o + 1]), T.Fp2(v[o + 2], v[o + 3]),
                     T.Fp2(v[o + 4], v[o + 5]))
    return T.Fp12(fp6(0), fp6(6))


def _j12(vals):
    v = list(vals)

    def fp6(o):
        return J.Fp6(J.Fp2(v[o], v[o + 1]), J.Fp2(v[o + 2], v[o + 3]),
                     J.Fp2(v[o + 4], v[o + 5]))
    return J.Fp12(fp6(0), fp6(6))


@pytest.fixture(scope="module")
def vectors():
    with open(_VEC_PATH) as fh:
        data = json.load(fh)
    pts = data["points"]
    return {
        "P": [tuple(int(v, 16) for v in pts[k]) for k in ("P1", "P2")],
        "w": int(pts["w"], 16),
        "miller": [[int(s, 16) for s in f] for f in data["miller"]],
        "pairing": [[int(s, 16) for s in f] for f in data["pairing"]],
    }


def test_constants_match():
    for name in ("U", "P", "R", "T", "B"):
        assert getattr(T, name) == getattr(J, name), name
    for name in ("_FROB6_1", "_FROB6_2", "_FROB12", "XI", "B_TWIST"):
        a, b = getattr(T, name), getattr(J, name)
        assert (a.a, a.b) == (b.a, b.b), name


def test_generators_match():
    gt, gj = T.g2_generator(), J.g2_generator()
    assert (gt.x.a, gt.x.b, gt.y.a, gt.y.b) == (gj.x.a, gj.x.b, gj.y.a, gj.y.b)
    assert T.G1.generator().is_on_curve()
    ft, fj = T.g2_frobenius(gt), J.g2_frobenius(gj)
    assert (ft.x.a, ft.x.b, ft.y.a, ft.y.b) == (fj.x.a, fj.x.b, fj.y.a, fj.y.b)
    k = 0xC0FFEE
    pt, pj = T.g1_mul(k, T.G1.generator()), J.g1_mul(k, J.G1.generator())
    assert (pt.x, pt.y) == (pj.x, pj.y)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_tower_ops_match(seed):
    rng = random.Random(seed)
    vals = [[rng.randrange(T.P) for _ in range(12)] for _ in range(2)]
    xt, yt = _t12(vals[0]), _t12(vals[1])
    xj, yj = _j12(vals[0]), _j12(vals[1])
    assert _ints12(xt * yt) == _ints12(xj * yj)
    assert _ints12(xt.sqr()) == _ints12(xj.sqr())
    assert _ints12(xt.inv()) == _ints12(xj.inv())
    assert _ints12(xt.frobenius()) == _ints12(xj.frobenius())
    assert _ints12(xt.conj()) == _ints12(xj.conj())
    assert _ints12(xt.pow(0xDEADBEEF)) == _ints12(xj.pow(0xDEADBEEF))
    a, b = T.Fp2(*vals[0][:2]), J.Fp2(*vals[0][:2])
    assert ((a.inv()).a, (a.inv()).b) == ((b.inv()).a, (b.inv()).b)
    assert (a.sqr().a, a.mul_xi().b) == (b.sqr().a, b.mul_xi().b)


@pytest.mark.parametrize("i", [0, 1])
def test_miller_loop_and_pairing_match_vectors(vectors, i):
    """Both packages' Miller loops and pairings on the pinned points
    equal the persisted vectors."""
    w = vectors["w"]
    Wt = T.g2_mul(w, T.g2_generator())
    Wj = J.g2_mul(w, J.g2_generator())
    pt, pj = T.G1(*vectors["P"][i]), J.G1(*vectors["P"][i])
    assert _ints12(T.miller_loop(pt, Wt)) == vectors["miller"][i]
    assert _ints12(J.miller_loop(pj, Wj)) == vectors["miller"][i]
    assert _ints12(T.pairing(pt, Wt)) == vectors["pairing"][i]
    assert _ints12(J.pairing(pj, Wj)) == vectors["pairing"][i]
