"""The port's plain Shamir ladders (fabric_mod_tpu_torch/ops/p256.py) against
the JAX reference's shamir_ladder / shamir_ladder_mixed.

Batch 3, the shape tests/test_p256_mixed.py already compiles; canonical
X, Y, Z must be bit-equal on random windows and the identity-adjacent
edge lanes.  The CUDA kernel wrapper must route a CPU tensor to the
plain version without launching anything."""
import random

import numpy as np
import pytest
import torch

from fabric_mod_tpu.ops import limbs9 as JL
from fabric_mod_tpu.ops import p256 as jp
from fabric_mod_tpu_torch.ops import limbs9 as TL
from fabric_mod_tpu_torch.ops import p256 as tp
from fabric_mod_tpu_torch.ops import p256_cuda


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain limb code is many small ops: one intra-op thread a
    worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BATCH = 3
R = 1 << 270


def _inputs(edge: int):
    """Windows + keys for BATCH lanes.  edge 0: lane 0 all-zero, lane 1
    G-adds only; edge 1: lane 0 Q-adds only, lane 1 one MSB window,
    lane 2 one LSB window."""
    rng = random.Random(0xAB + edge)
    pts = [tp.g_multiples()[k] for k in (1, 4, 13)]
    qx = np.stack([JL.int_to_limbs(x * R % tp.P) for x, _ in pts]).T.copy()
    qy = np.stack([JL.int_to_limbs(y * R % tp.P) for _, y in pts]).T.copy()
    u1 = np.array([[rng.randrange(16) for _ in range(BATCH)]
                   for _ in range(tp.N_WINDOWS)], np.int32)
    u2 = np.array([[rng.randrange(16) for _ in range(BATCH)]
                   for _ in range(tp.N_WINDOWS)], np.int32)
    if edge == 0:
        u1[:, 0] = 0
        u2[:, 0] = 0
        u2[:, 1] = 0
    else:
        u1[:, 0] = 0
        u1[1:, 1] = 0
        u2[:tp.N_WINDOWS - 1, 2] = 0
    return u1, u2, qx, qy


def _canon_ref(xyz):
    fp = JL.FieldSpec.make("p256.p", jp.P)
    return [np.asarray(JL.canonical(c, fp)) for c in xyz]


def _canon_port(xyz):
    fp = tp._consts()[0]
    return [TL.canonical(c, fp).numpy() for c in xyz]


def _run_both(mixed: bool, edge: int):
    import jax.numpy as jnp
    u1, u2, qx, qy = _inputs(edge)
    ref = jp.shamir_ladder_mixed if mixed else jp.shamir_ladder
    port = tp.shamir_ladder_mixed if mixed else tp.shamir_ladder
    want = _canon_ref(ref(jnp.asarray(u1), jnp.asarray(u2),
                          jnp.asarray(qx), jnp.asarray(qy)))
    got = _canon_port(port(torch.from_numpy(u1), torch.from_numpy(u2),
                           torch.from_numpy(qx), torch.from_numpy(qy)))
    return want, got


@pytest.mark.parametrize("edge", [0, 1])
def test_projective_ladder_matches_reference(edge):
    want, got = _run_both(False, edge)
    for w, g, name in zip(want, got, "XYZ"):
        assert np.array_equal(w, g), name
    if edge == 0:
        assert not got[2][:, 0].any()          # all-zero lane: Z = 0


def test_point_ops_match_reference():
    """RCB add / mixed add / double on generic, equal, opposite and
    identity inputs: same canonical outputs as the reference."""
    import jax.numpy as jnp
    pts = [tp.g_multiples()[k] for k in (2, 6, 6, 9)]
    opp = (pts[3][0], tp.P - pts[3][1])
    one = R % tp.P

    def proj(ps):
        return tuple(np.stack([JL.int_to_limbs(v) for v in col]).T.copy()
                     for col in zip(*[(0, one, 0) if p is None else
                                      (p[0] * R % tp.P, p[1] * R % tp.P, one)
                                      for p in ps]))
    a = proj([pts[0], pts[1], None, pts[3]])
    b = proj([pts[1], pts[2], pts[0], opp])
    fpj, _, bmj, _, _ = jp._consts()
    fpt, _, bmt, _, _ = tp._consts()
    aj = tuple(jnp.asarray(x) for x in a)
    bj = tuple(jnp.asarray(x) for x in b)
    at = tuple(torch.from_numpy(x) for x in a)
    bt = tuple(torch.from_numpy(x) for x in b)
    cases = [
        (jp.point_add(aj, bj, fpj, JL.const_like(bmj, aj[0])),
         tp.point_add(at, bt, fpt, TL.const_like(bmt, at[0]))),
        (jp.point_add_mixed(aj, bj[:2], fpj, JL.const_like(bmj, aj[0])),
         tp.point_add_mixed(at, bt[:2], fpt, TL.const_like(bmt, at[0]))),
        (jp.point_double(aj, fpj, JL.const_like(bmj, aj[0])),
         tp.point_double(at, fpt, TL.const_like(bmt, at[0]))),
    ]
    for want, got in cases:
        for w, g in zip(_canon_ref(want), _canon_port(got)):
            assert np.array_equal(w, g)


def test_inv_chain_matches_generic_inverse():
    fp = tp._consts()[0]
    rng = random.Random(3)
    vals = [rng.randrange(1, tp.P) for _ in range(3)] + [0]
    a = torch.from_numpy(np.stack([JL.int_to_limbs(v * R % tp.P)
                                   for v in vals]).T.copy())
    got = TL.canonical(tp.inv_mont_p_chain(a, fp), fp)
    assert torch.equal(got, TL.canonical(TL.inv_mont(a, fp), fp))
    with pytest.raises(ValueError):
        tp.inv_mont_p_chain(a, tp._consts()[1])


@pytest.mark.parametrize("mixed", [False, True])
def test_kernel_wrapper_routes_cpu_tensors_to_plain(mixed):
    """p256_cuda.ladder on a CPU tensor IS the plain ladder: same
    output, no kernel launch counted."""
    u1, u2, qx, qy = (torch.from_numpy(a) for a in _inputs(1))
    before = p256_cuda.counts()
    plain = tp.shamir_ladder_mixed if mixed else tp.shamir_ladder
    got = p256_cuda.ladder(u1, u2, qx, qy, mixed=mixed)
    want = plain(u1, u2, qx, qy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert p256_cuda.counts() == before
