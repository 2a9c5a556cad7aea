"""The port's plain limb layer (fabric_mod_tpu_torch/ops/limbs9.py) against
the JAX reference (fabric_mod_tpu/ops/limbs9.py) on random values.

Inputs are made with numpy/python from a fixed seed and handed to both.
Every comparison is exact: canonical limbs bit-equal, and for the
Montgomery products the lazy limbs too (the port keeps the reference's
rounded-carry schedule)."""
import random

import numpy as np
import pytest
import torch

from fabric_mod_tpu.ops import limbs9 as J
from fabric_mod_tpu_torch.ops import limbs9 as T

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
R = 1 << 270


@pytest.fixture(scope="module", params=[("p", P), ("n", N)],
                ids=["field_p", "field_n"])
def field(request):
    name, mod = request.param
    return J.FieldSpec.make(name, mod), T.FieldSpec.make(name, mod), mod


def _operands(mod, seed, lanes=12):
    rng = random.Random(seed)
    vals = [rng.randrange(mod) for _ in range(lanes - 3)] + [0, 1, mod - 1]
    a = np.stack([J.int_to_limbs(v * R % mod) for v in vals]).T.copy()
    return vals, a


def _jt(a_np):
    import jax.numpy as jnp
    return jnp.asarray(a_np), torch.from_numpy(a_np.copy())


def _eq(j, t):
    return np.array_equal(np.asarray(j), t.numpy())


def test_fieldspec_constants_match(field):
    fj, ft, _ = field
    for name in ("p", "one", "one_mont", "r2", "np_mat", "p_mat", "kp32",
                 "lift32"):
        assert np.array_equal(getattr(fj, name), getattr(ft, name)), name


@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_match_reference(field, op):
    fj, ft, mod = field
    _, a = _operands(mod, 1)
    _, b = _operands(mod, 2)
    aj, at = _jt(a)
    bj, bt = _jt(b)
    if op == "mont_mul":
        gj, gt = J.mont_mul(aj, bj, fj), T.mont_mul(at, bt, ft)
        assert _eq(gj, gt)                     # lazy limbs, bit for bit
    else:
        gj, gt = getattr(J, op)(aj, bj), getattr(T, op)(at, bt)
    assert _eq(J.canonical(gj, fj), T.canonical(gt, ft))


def test_mont_sqr_matches_reference(field):
    fj, ft, mod = field
    _, a = _operands(mod, 3)
    aj, at = _jt(a)
    assert _eq(J.mont_sqr(aj, fj), T.mont_sqr(at, ft))
    assert _eq(J.canonical(J.mont_sqr(aj, fj), fj),
               T.canonical(T.mont_sqr(at, ft), ft))


def test_canonical_of_lazy_values(field):
    """Signed lazy limbs (|value| < 2^260) canonicalise identically."""
    fj, ft, mod = field
    rng = np.random.default_rng(4)
    a = rng.integers(-273, 274, (T.K, 16)).astype(np.float32)
    a[-2:] = 0                                 # keep |value| < 2^260
    aj, at = _jt(a)
    assert _eq(J.canonical(aj, fj), T.canonical(at, ft))
    assert _eq(J.eq_zero(aj, fj), T.eq_zero(at, ft))


def test_inv_mont_matches_reference(field):
    fj, ft, mod = field
    vals, a = _operands(mod, 5, lanes=6)
    aj, at = _jt(a)
    got = T.canonical(T.inv_mont(at, ft), ft)
    assert _eq(J.canonical(J.inv_mont(aj, fj), fj), got)
    rinv = pow(R, -1, mod)
    for lane, v in enumerate(vals):
        g = T.limbs_to_int(got[:, lane]) * rinv % mod
        assert g == (pow(v, -1, mod) if v else 0)


def test_inv_mont_many_matches_reference():
    """Simultaneous inversion, one lane poisoned by a zero."""
    fj, ft = J.FieldSpec.make("p", P), T.FieldSpec.make("p", P)
    rng = random.Random(6)
    rows = [[rng.randrange(1, P) for _ in range(3)] for _ in range(4)]
    rows[2][1] = 0
    arrs = [np.stack([J.int_to_limbs(v * R % P) for v in row]).T.copy()
            for row in rows]
    want = J.inv_mont_many([_jt(a)[0] for a in arrs], fj)
    got = T.inv_mont_many([_jt(a)[1] for a in arrs], ft)
    for w, g in zip(want, got):
        assert _eq(J.canonical(w, fj), T.canonical(g, ft))
    assert (T.canonical(got[0], ft)[:, 1] == 0).all()     # poisoned lane


def test_bits_le_and_mul_small(field):
    fj, ft, mod = field
    _, a = _operands(mod, 7)
    aj, at = _jt(a)
    assert _eq(J.bits_le(J.canonical(aj, fj)), T.bits_le(T.canonical(at, ft)))
    assert _eq(J.canonical(J.mul_small(aj, 3), fj),
               T.canonical(T.mul_small(at, 3), ft))


def test_words_limbs_round_trip():
    """The kernels' 8 x 32-bit word form <-> canonical 9-bit limbs."""
    rng = random.Random(8)
    vals = [rng.randrange(1 << 256) for _ in range(9)] + [0, (1 << 256) - 1]
    limbs = torch.tensor(np.stack([J.int_to_limbs(v) for v in vals]).T
                         .astype(np.int64))
    words = T.limbs_to_words(limbs)
    for lane, v in enumerate(vals):
        assert sum(int(words[k, lane]) << (32 * k) for k in range(8)) == v
    assert torch.equal(T.words_to_limbs(words), limbs)
