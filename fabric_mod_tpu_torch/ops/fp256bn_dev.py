"""Batched FP256BN optimal-ate pairing as plain PyTorch ops.

The port of fabric_mod_tpu/ops/fp256bn_dev.py (a jitted XLA program in
the reference, no Pallas kernel).  Semantics are pinned by the host
implementation in idemix/fp256bn.py; idemix's Ver checks
e(A', W) == e(Abar, g2) as e(A', W) * e(-Abar, g2) == 1 here, batched
over presentations.

Design (the reference's, executed eagerly):
* The G2 arguments are shared across a batch (the issuer's W and the
  fixed g2), so every G2 step of the Miller loop — doublings, additions
  and line slopes — is precomputed once per G2 point on the host as a
  static `LineSchedule` of sparse line constants (uploaded once per
  device).  The device work is the per-lane line evaluation and the
  Fp12 square/multiply chain over the f32 limb layer of ops/limbs9.py.
* Sparse lines: the line through T with slope lam' evaluated at an Fp
  point (xP, yP) is  yP·1 + A·(v·w) + (B·xP)·(v²·w),  A = (lam'·xT −
  yT)/xi,  B = −lam'/xi, so the accumulator multiply is 42 Montgomery
  products, not 54.
* Final exponentiation: the easy part, then the Devegili–Scott–Dominguez
  chain of three |u|-exponentiations in the cyclotomic subgroup.

Layout: the limb axis first, then the tower axes, then the batch:
Fp (K, *b); Fp2 (K, 2, *b); Fp6 (K, 2, 3, *b) — axis 2 the Fp6
coefficient; Fp12 (K, 2, 3, 2, *b) — axis 3 the w coefficient.  So the
reference's Fp2 component x[j] is x[:, j], an Fp6 coefficient x[i] is
x[:, :, i], and an Fp12 half x[h] is x[:, :, :, h].  Stacking several
values of one type along a new axis just after its own axes gives a
value of the same type with a longer batch, which every operation here
accepts.  Adding or subtracting two values of any tower level is one
`limbs.add` / `limbs.sub` over the whole tensor, so the reference's
f2_add, f6_sub and the like have no separate function here.

Launches: each tower operation stacks its independent Montgomery
products into one `mont_mul` call (Fp2's 3, Fp6's 6 Fp2 products = 18,
Fp12's 3 Fp6 products = 54, the line multiply's 42) and its matching
adds and subs into one `carried` each.  Every element still goes
through exactly the reference's sequence of limb operations, column by
column, in exact f32 integer arithmetic, so the limb planes are
bit-equal to the reference's unstacked ones.  The scans become host
loops over the static schedule; where the reference computes a value
and drops it with `where` (the squaring on a Miller add-step, the
multiply on a zero bit of |u|) it is skipped — the selected value is
the unmodified operand, so the output is the same.  The two Miller
loops of a pairing check share one control flow and run stacked.

On the card `pairing_check_batch` and `pairing_batch` run the
hand-written kernels of csrc/fp256bn_pairing.cu through
ops/fp256bn_cuda.py: one Miller launch and one final-exponentiation
launch a call.  The torch-ops bodies above are their plain versions
(`pairing_check_plain`, `pairing_batch_plain`), which run on the CPU.
"""
from __future__ import annotations

import collections
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch import device as _device
from fabric_mod_tpu_torch.idemix import fp256bn as host
from fabric_mod_tpu_torch.ops import fp256bn_cuda as cuda
from fabric_mod_tpu_torch.ops import limbs9 as limbs

SPEC = limbs.FieldSpec.make("fp256bn.p", host.P)
_R = 1 << limbs.RBITS
K = limbs.K

# pairing checks / pairings run, by the device type they ran on
PASSES: "collections.Counter[str]" = collections.Counter()


def reset_counts() -> None:
    PASSES.clear()


def counts() -> dict:
    return dict(PASSES)


def _mont_np(x: int) -> np.ndarray:
    """Host int -> canonical limbs of x*R mod p (Montgomery form)."""
    return limbs.int_to_limbs((x % host.P) * _R % host.P)


def _mont_fp2_np(x: "host.Fp2") -> np.ndarray:
    """(2, K) Montgomery limbs of an Fp2 constant."""
    return np.stack([_mont_np(x.a), _mont_np(x.b)])


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _bcast(*ts: torch.Tensor) -> List[torch.Tensor]:
    """Broadcast limb-first tensors against each other: a tensor of lower
    rank gains trailing unit axes first (a constant has no batch)."""
    n = max(t.dim() for t in ts)
    return list(torch.broadcast_tensors(
        *(t.reshape(tuple(t.shape) + (1,) * (n - t.dim())) for t in ts)))


def _stack(ts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    return torch.stack(_bcast(*ts), dim)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return limbs.mont_mul(a, b, SPEC)


# ---------------------------------------------------------------------------
# Fp2 = Fp[i]/(i^2 + 1): (K, 2, *b)
# ---------------------------------------------------------------------------

def f2_neg(x):
    return limbs.carried(-x)


def f2_conj(x):
    return torch.stack([x[:, 0], f2_neg(x[:, 1])], 1)


def _f2_mul_operands(x, y):
    """Karatsuba operands as (K, 3, *b) pairs: (x0, x1, x0 + x1) and
    (y0, y1, y0 + y1) — both sums in one carry."""
    x, y = _bcast(x, y)
    s = limbs.add(torch.stack([x[:, 0], y[:, 0]], 1),
                  torch.stack([x[:, 1], y[:, 1]], 1))
    return torch.cat([x, s[:, :1]], 1), torch.cat([y, s[:, 1:]], 1)


def _f2_mul_finish(t):
    """Karatsuba products (K, 3, *b) t0, t1, t2 -> (t0 − t1, t2 − (t0 + t1))."""
    u = limbs.add(t[:, 0], t[:, 1])
    return limbs.sub(t[:, 0::2], torch.stack([t[:, 1], u], 1))


def f2_mul(x, y):
    """Karatsuba: 3 Montgomery products, in one call."""
    return _f2_mul_finish(_mul(*_f2_mul_operands(x, y)))


def f2_sqr(x):
    """(a + b)(a − b), 2ab: 2 Montgomery products, in one call."""
    a, b = x[:, 0], x[:, 1]
    s = limbs.carried(torch.stack([a + b, a - b], 1))
    m = _mul(torch.stack([s[:, 0], a], 1), torch.stack([s[:, 1], b], 1))
    return torch.stack([m[:, 0], limbs.mul_small(m[:, 1], 2)], 1)


def f2_mul_fp(x, s):
    """Fp2 scaled by an Fp element of the same batch: 2 products."""
    return _mul(x, s.unsqueeze(1))


def f2_mul_xi(x):
    """xi = 1 + i: (a − b, a + b), adds only."""
    return limbs.carried(torch.stack([x[:, 0] - x[:, 1],
                                      x[:, 0] + x[:, 1]], 1))


def f2_inv(x):
    sq = limbs.mont_sqr(x, SPEC)
    d = limbs.inv_mont(limbs.add(sq[:, 0], sq[:, 1]), SPEC)
    m = _mul(x, d.unsqueeze(1))
    return torch.stack([m[:, 0], f2_neg(m[:, 1])], 1)


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 − xi): (K, 2, 3, *b)
# ---------------------------------------------------------------------------

def f6_neg(x):
    return limbs.carried(-x)


def _f6_mul_finish(t):
    """The six Fp2 products t0, t1, t2, m12, m01, m02 (axis 2) of the
    Toom-style product -> its three coefficients."""
    t0, t1, t2 = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    u = limbs.add(torch.stack([t1, t0, t0], 2), torch.stack([t2, t1, t2], 2))
    v = limbs.sub(t[:, :, 3:], u)
    w = f2_mul_xi(torch.stack([v[:, :, 0], t2], 2))
    return limbs.add(torch.stack([w[:, :, 0], v[:, :, 1], v[:, :, 2]], 2),
                     torch.stack([t0, w[:, :, 1], t1], 2))


def f6_mul(x, y):
    """Toom-style 6-product Fp6 product: 18 Montgomery products."""
    x, y = _bcast(x, y)
    a0, a1, a2 = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    b0, b1, b2 = y[:, :, 0], y[:, :, 1], y[:, :, 2]
    s = limbs.add(torch.stack([a1, a0, a0, b1, b0, b0], 2),
                  torch.stack([a2, a1, a2, b2, b1, b2], 2))
    return _f6_mul_finish(f2_mul(torch.cat([x, s[:, :, :3]], 2),
                                 torch.cat([y, s[:, :, 3:]], 2)))


def _sparse_finish(t):
    """The five Fp2 products t1, t2, m12, m01, m02 (axis 2) of
    x * Fp6(0, b1, b2) -> its three coefficients."""
    t1, t2 = t[:, :, 0], t[:, :, 1]
    u = limbs.add(t1, t2)
    v = limbs.sub(t[:, :, 2:], torch.stack([u, t1, t2], 2))
    w = f2_mul_xi(torch.stack([v[:, :, 0], t2], 2))
    c12 = limbs.add(v[:, :, 1:], torch.stack([w[:, :, 1], t1], 2))
    return torch.cat([w[:, :, :1], c12], 2)


def f6_mul_sparse12(x, b1, b2):
    """x * Fp6(0, b1, b2): 15 Montgomery products."""
    a0, a1, a2 = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    s = limbs.add(_stack([a1, a0, a0, b1], 2), _stack([a2, a1, a2, b2], 2))
    X = _stack([a1, a2, s[:, :, 0], s[:, :, 1], s[:, :, 2]], 2)
    Y = _stack([b1, b2, s[:, :, 3], b1, b2], 2)
    return _sparse_finish(f2_mul(X, Y))


def f6_mul_v(x):
    return torch.stack([f2_mul_xi(x[:, :, 2]), x[:, :, 0], x[:, :, 1]], 2)


def f6_inv(x):
    a0, a1, a2 = x[:, :, 0], x[:, :, 1], x[:, :, 2]
    sq = f2_sqr(torch.stack([a0, a2, a1], 2))                 # a0², a2², a1²
    pr = f2_mul(torch.stack([a1, a0, a0], 2),
                torch.stack([a2, a1, a2], 2))                 # a1a2, a0a1, a0a2
    xi = f2_mul_xi(torch.stack([pr[:, :, 0], sq[:, :, 1]], 2))
    t = limbs.sub(torch.stack([sq[:, :, 0], xi[:, :, 1], sq[:, :, 2]], 2),
                  torch.stack([xi[:, :, 0], pr[:, :, 1], pr[:, :, 2]], 2))
    q = f2_mul(torch.stack([a0, a2, a1], 2), t)               # a0t0, a2t1, a1t2
    xq = f2_mul_xi(q[:, :, 1:])
    d = limbs.add(q[:, :, 0], limbs.add(xq[:, :, 0], xq[:, :, 1]))
    return f2_mul(t, f2_inv(d).unsqueeze(2))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 − v): (K, 2, 3, 2, *b)
# ---------------------------------------------------------------------------

def f12_mul(x, y):
    """Karatsuba over Fp6: 54 Montgomery products, in one call."""
    x, y = _bcast(x, y)
    a0, a1 = x[:, :, :, 0], x[:, :, :, 1]
    b0, b1 = y[:, :, :, 0], y[:, :, :, 1]
    s = limbs.add(torch.stack([a0, b0], 3), torch.stack([a1, b1], 3))
    t = f6_mul(torch.stack([a0, a1, s[:, :, :, 0]], 3),
               torch.stack([b0, b1, s[:, :, :, 1]], 3))
    t0, t1 = t[:, :, :, 0], t[:, :, :, 1]
    u = limbs.add(torch.stack([t0, t0], 3), torch.stack([f6_mul_v(t1), t1], 3))
    return torch.stack([u[:, :, :, 0], limbs.sub(t[:, :, :, 2], u[:, :, :, 1])], 3)


def f12_sqr(x):
    """36 Montgomery products, in one call."""
    a0, a1 = x[:, :, :, 0], x[:, :, :, 1]
    s = limbs.add(torch.stack([a0, a0], 3), torch.stack([a1, f6_mul_v(a1)], 3))
    t = f6_mul(torch.stack([a0, s[:, :, :, 0]], 3),
               torch.stack([a1, s[:, :, :, 1]], 3))
    t0 = t[:, :, :, 0]
    u = limbs.add(torch.stack([t0, t0], 3), torch.stack([f6_mul_v(t0), t0], 3))
    return torch.stack([limbs.sub(t[:, :, :, 1], u[:, :, :, 0]),
                        u[:, :, :, 1]], 3)


def f12_conj(x):
    return torch.stack([x[:, :, :, 0], f6_neg(x[:, :, :, 1])], 3)


def f12_inv(x):
    sq = f6_mul(x, x)                                         # a0², a1²
    t = f6_inv(limbs.sub(sq[:, :, :, 0], f6_mul_v(sq[:, :, :, 1])))
    p = f6_mul(x, t.unsqueeze(3))                             # a0·t, a1·t
    return torch.stack([p[:, :, :, 0], f6_neg(p[:, :, :, 1])], 3)


def _line_y(A, Bxp):
    """The y-side Karatsuba operands of the sparse line multiply,
    (K, 3, 5, *b): for each of its five Fp2 products (b1, b2, b1 + b2,
    b1, b2 with b1 = A, b2 = B·xP) the components and their sum.  They
    depend only on the line, so a Miller loop makes them for every step
    at once."""
    bs = limbs.add(A, Bxp)
    Y = _stack([A, Bxp, bs, A, Bxp], 2)
    return torch.cat([Y, limbs.add(Y[:, 0], Y[:, 1]).unsqueeze(1)], 1)


def _mul_line(f, yp, ly):
    """f * l for the sparse line l = yp·1 + A·(v·w) + Bxp·(v²·w) given
    its y-side operands `ly` (`_line_y`): the two sparse Fp6 products
    (30 Montgomery products) and f·yp (12) in one call."""
    a0, a1, a2 = f[:, :, 0], f[:, :, 1], f[:, :, 2]     # both halves each
    s = limbs.add(torch.stack([a1, a0, a0], 2), torch.stack([a2, a1, a2], 2))
    X = torch.cat([f[:, :, 1:], s], 2)                   # (K, 2, 5, 2, *b)
    LX = torch.cat([X, limbs.add(X[:, 0], X[:, 1]).unsqueeze(1)], 1)
    ly, LX = _bcast(ly.unsqueeze(3), LX)
    lhs = torch.cat([LX.flatten(1, 3), f.flatten(1, 3)], 1)
    rhs = torch.cat([ly.flatten(1, 3),
                     yp.unsqueeze(1).expand((K, 12) + tuple(f.shape[4:]))], 1)
    r = _mul(lhs, rhs)
    sp = _sparse_finish(_f2_mul_finish(r[:, :30].reshape(LX.shape)))
    fy = r[:, 30:].reshape(f.shape)                      # a0·yp, a1·yp
    # (a0 + a1 w)·l = (a0·yp + v·(a1·l1)) + (a0·l1 + a1·yp) w
    return limbs.add(torch.stack([fy[:, :, :, 0], sp[:, :, :, 0]], 3),
                     torch.stack([f6_mul_v(sp[:, :, :, 1]), fy[:, :, :, 1]], 3))


def f12_mul_line(f, yp, A, Bxp):
    """f * l where l = yp·1 + A·(v·w) + Bxp·(v²·w) — the sparse line
    (l.c0 = (yp, 0, 0); l.c1 = (0, A, Bxp)): 12 + 30 = 42 products."""
    return _mul_line(f, yp, _line_y(A, Bxp))


# Frobenius constants (Montgomery, numpy) — x -> x^p on Fp12, for the
# coefficients (Fp6 index, half) (1, 0), (2, 0), (0, 1), (1, 1), (2, 1)
_FROB_AT = ((1, 0), (2, 0), (0, 1), (1, 1), (2, 1))
_FROB = np.ascontiguousarray(np.stack([
    _mont_fp2_np(c) for c in (
        host._FROB6_1, host._FROB6_2, host._FROB12,
        host._FROB12 * host._FROB6_1, host._FROB12 * host._FROB6_2)],
    axis=-1).transpose(1, 0, 2))                         # (K, 2, 5)


def f12_frobenius(x):
    c = f2_conj(x)
    m = f2_mul(torch.stack([c[:, :, i, h] for i, h in _FROB_AT], 2),
               limbs.const(_FROB, x.device))
    return torch.stack([
        torch.stack([c[:, :, 0, 0], m[:, :, 0], m[:, :, 1]], 2),
        torch.stack([m[:, :, 2], m[:, :, 3], m[:, :, 4]], 2)], 3)


def f12_one(like):
    """Montgomery one with the batch of the Fp value `like` (K, *b)."""
    one = torch.zeros((K, 2, 3, 2) + tuple(like.shape[1:]),
                      dtype=torch.float32, device=like.device)
    one[:, 0, 0, 0] = limbs.const_like(SPEC.one_mont, like)
    return one


def f12_is_one(x):
    """(*b,) bool: is x == 1 (every coefficient canonical-checked)."""
    d = x.clone()
    d[:, 0, 0, 0] = limbs.sub(x[:, 0, 0, 0],
                              limbs.const(SPEC.one_mont, x.device))
    return (limbs.canonical(d, SPEC) == 0).flatten(0, 3).all(0)


# ---------------------------------------------------------------------------
# Host: static line schedule per G2 point (shared across the batch)
# ---------------------------------------------------------------------------

class LineSchedule:
    """Stacked per-step line coefficients for one G2 point.

    Arrays (all numpy, Montgomery limbs):
      is_add: (N,) bool — add-step (no squaring before the multiply)
      A, B:   (N, 2, K) — the Fp2 line constants per step
      corr_A, corr_B: (2, 2, K) — the two Frobenius correction lines
    `tensors(device)` uploads them once per device; `line_words()` gives
    the kernels' form of the same constants."""

    def __init__(self, is_add, A, B, corr_A, corr_B):
        self.is_add = is_add
        self.A = A
        self.B = B
        self.corr_A = corr_A
        self.corr_B = corr_B
        self._on: dict = {}

    def tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A, B) with the correction lines appended, as (K, 2, N + 2)
        f32 tensors on `device`."""
        key = str(device)
        hit = self._on.get(key)
        if hit is None:
            hit = self._on[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(
                    np.concatenate([main, corr]).transpose(2, 1, 0)),
                    dtype=torch.float32, device=device)
                for main, corr in ((self.A, self.corr_A),
                                   (self.B, self.corr_B)))
        return hit

    def line_words(self) -> np.ndarray:
        """(N + 2, 4, 8) int32 canonical words of A.a, A.b, B.a, B.b a
        step, the correction lines last — the kernels' own form (they
        take no value of the limb layer's R = 2^270 domain)."""
        hit = self._on.get("words")
        if hit is None:
            r_inv = pow(_R, -1, host.P)
            mont = np.stack([np.concatenate([self.A, self.corr_A]),
                             np.concatenate([self.B, self.corr_B])], 1)
            vals = [limbs.limbs_to_int(v) * r_inv % host.P
                    for v in mont.reshape(-1, K)]
            hit = self._on["words"] = np.ascontiguousarray(
                cuda.int_words(vals).T.reshape(len(mont), 4, 8))
        return hit


@functools.lru_cache(maxsize=32)
def _schedule_cached(qx_a: int, qx_b: int, qy_a: int, qy_b: int
                     ) -> LineSchedule:
    q = host.G2(host.Fp2(qx_a, qx_b), host.Fp2(qy_a, qy_b))
    return _build_schedule(q)


def line_schedule(q: "host.G2") -> LineSchedule:
    return _schedule_cached(q.x.a, q.x.b, q.y.a, q.y.b)


def _build_schedule(q: "host.G2") -> LineSchedule:
    """Replicates host.miller_loop's control flow on G2 only, recording
    A = (lam·xT − yT)/xi and B = −lam/xi per line (host math; runs once
    per G2 point and is cached)."""
    xi_inv = host.XI.inv()
    state = {"t": q}
    steps: List[Tuple[bool, "host.Fp2", "host.Fp2"]] = []

    def rec(q2, is_add: bool) -> None:
        q1 = state["t"]
        if q1.x == q2.x and (q1.y + q2.y).is_zero():
            raise ValueError("degenerate (vertical) line in pairing schedule")
        if q1 == q2:
            lam = (q1.x.sqr() * 3) * (q1.y * 2).inv()
        else:
            lam = (q2.y - q1.y) * (q2.x - q1.x).inv()
        A = (lam * q1.x - q1.y) * xi_inv
        Bc = -lam * xi_inv
        x3 = lam.sqr() - q1.x - q2.x
        state["t"] = host.G2(x3, lam * (q1.x - x3) - q1.y)
        steps.append((is_add, A, Bc))

    e = abs(6 * host.U + 2)
    for bit in bin(e)[3:]:
        rec(state["t"], False)
        if bit == "1":
            rec(q, True)
    # 6u+2 < 0 for this curve: conjugate f (device side) and negate T
    state["t"] = state["t"].neg()
    n_main = len(steps)
    q1f = host.g2_frobenius(q)
    q2f = host.g2_frobenius(q1f).neg()
    rec(q1f, True)
    rec(q2f, True)
    main, corr = steps[:n_main], steps[n_main:]
    return LineSchedule(
        is_add=np.array([s[0] for s in main], np.bool_),
        A=np.stack([_mont_fp2_np(s[1]) for s in main]),
        B=np.stack([_mont_fp2_np(s[2]) for s in main]),
        corr_A=np.stack([_mont_fp2_np(s[1]) for s in corr]),
        corr_B=np.stack([_mont_fp2_np(s[2]) for s in corr]),
    )


# ---------------------------------------------------------------------------
# Device: Miller loop + final exponentiation
# ---------------------------------------------------------------------------

def _line_operands(xp, A, B):
    """`_line_y` of every step at once: A, B (K, 2, S, *bc) line
    constants, xp (K, *b) -> (K, 3, 5, S, *b)."""
    return _line_y(A, _mul(B, xp.unsqueeze(1).unsqueeze(1)))


def _miller_step(f, yp, ly, is_add: bool):
    """One Miller step: the squaring (not on an add-step), then the line."""
    if not is_add:
        f = f12_sqr(f)
    return _mul_line(f, yp, ly)


def _miller(xp, yp, A, B, is_add):
    """The Miller loop over a schedule's main steps, the conjugation
    (6u+2 < 0) and the two Frobenius correction lines."""
    ly = _line_operands(xp, A, B)
    f = f12_one(xp)
    n_main = len(is_add)
    for s in range(n_main):
        f = _miller_step(f, yp, ly[:, :, :, s], bool(is_add[s]))
    f = f12_conj(f)
    for s in (n_main, n_main + 1):
        f = _mul_line(f, yp, ly[:, :, :, s])
    return f


def miller_batch(xp_m, yp_m, sched: LineSchedule):
    """Batched Miller loop: (K, batch) Montgomery G1 coordinates against
    one precomputed schedule, on the coordinates' device."""
    A, B = sched.tensors(xp_m.device)
    pad = (1,) * (xp_m.dim() - 1)
    return _miller(xp_m, yp_m, A.reshape(A.shape + pad),
                   B.reshape(B.shape + pad), sched.is_add)


def _pow_abs_u(f):
    """f^|u|, square-and-multiply over the static bits of |u| (f must be
    in the cyclotomic subgroup)."""
    acc = f12_one(f[:, 0, 0, 0])
    for bit in bin(abs(host.U))[2:]:
        acc = f12_sqr(acc)
        if bit == "1":
            acc = f12_mul(acc, f)
    return acc


def _pow_u(f):
    """f^u (u < 0): conj of f^|u| — cyclotomic inverse is conjugation."""
    return f12_conj(_pow_abs_u(f))


def _easy_part(f):
    """f^(p^6 − 1) then ^(p^2 + 1)."""
    f = f12_mul(f12_conj(f), f12_inv(f))
    return f12_mul(f12_frobenius(f12_frobenius(f)), f)


def _hard_tail(f, fu, fu2, fu3):
    """The Devegili–Scott–Dominguez combination of f, f^u, f^u², f^u³."""
    fp = f12_frobenius(f)
    fp2 = f12_frobenius(fp)
    fp3 = f12_frobenius(fp2)
    y0 = f12_mul(f12_mul(fp, fp2), fp3)
    y1 = f12_conj(f)
    y2 = f12_frobenius(f12_frobenius(fu2))
    y3 = f12_conj(f12_frobenius(fu))
    y4 = f12_conj(f12_mul(fu, f12_frobenius(fu2)))
    y5 = f12_conj(fu2)
    y6 = f12_conj(f12_mul(fu3, f12_frobenius(fu3)))
    t0 = f12_mul(f12_mul(f12_sqr(y6), y4), y5)
    t1 = f12_mul(f12_mul(y3, y5), t0)
    t0 = f12_mul(t0, y2)
    t1 = f12_sqr(f12_mul(f12_sqr(t1), t0))
    t0 = f12_mul(t1, y1)
    t1 = f12_mul(t1, y0)
    t0 = f12_sqr(t0)
    return f12_mul(t0, t1)


def final_exp_batch(f):
    """f^((p^12 − 1)/r): the easy part, then the DSD u-chain hard part
    (not the naive 766-bit exponent)."""
    f = _easy_part(f)
    fu = _pow_u(f)
    fu2 = _pow_u(fu)
    return _hard_tail(f, fu, fu2, _pow_u(fu2))


# ---------------------------------------------------------------------------
# The verify surface
# ---------------------------------------------------------------------------

def _g1_batch_to_mont(points, dev: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[host.G1] -> two (K, batch) Montgomery limb tensors on `dev`."""
    xs = np.stack([_mont_np(p.x) for p in points])
    ys = np.stack([_mont_np(p.y) for p in points])
    return limbs.to_device(xs, dev), limbs.to_device(ys, dev)


def _check_args(a_points, q1, b_points, q2):
    if len(a_points) != len(b_points):
        raise ValueError("a_points and b_points differ in length")
    s1, s2 = line_schedule(q1), line_schedule(q2)
    if not np.array_equal(s1.is_add, s2.is_add):
        raise ValueError("schedules differ in control flow")
    return s1, s2


def pairing_check_batch(a_points, q1: "host.G2", b_points, q2: "host.G2",
                        device=None, lazy: bool = False):
    """(batch,) bool: e(A_i, Q1) * e(B_i, Q2) == 1 for each i.

    For idemix Ver's `e(A', W) == e(Abar, g2)` pass B_i = −Abar_i
    (negation is host-side).  Q1/Q2 schedules are built once per point.
    Runs on the card unless `device` says otherwise: there as two
    kernel launches (the Miller loops of both schedules, then the pair
    product, final exponentiation and verdict), on the CPU as the plain
    version.  Returns numpy, or with `lazy=True` the verdict tensor on
    the device."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return pairing_check_plain(a_points, q1, b_points, q2, dev, lazy)
    s1, s2 = _check_args(a_points, q1, b_points, q2)
    PASSES[dev.type] += 1
    if not a_points:
        ok = torch.zeros(0, dtype=torch.bool, device=dev)
        return ok if lazy else ok.cpu().numpy()
    pts = np.stack([cuda.point_words(a_points), cuda.point_words(b_points)])
    lines = np.stack([s1.line_words(), s2.line_words()])
    f = cuda.miller(_device.upload(pts, dev), _device.upload(lines, dev),
                    _device.upload(s1.is_add.astype(np.int32), dev))
    ok = cuda.final_exp(f, check=True)
    return ok if lazy else ok.cpu().numpy()


def pairing_check_plain(a_points, q1: "host.G2", b_points, q2: "host.G2",
                        device=None, lazy: bool = False):
    """`pairing_check_batch` as plain torch ops on any device: both
    Miller loops stacked, uploaded schedules, the limb layer."""
    dev = _device.resolve(device)
    _device.require_exact_fp32()
    s1, s2 = _check_args(a_points, q1, b_points, q2)
    PASSES[dev.type] += 1
    if not a_points:
        ok = torch.zeros(0, dtype=torch.bool, device=dev)
        return ok if lazy else ok.cpu().numpy()
    ax, ay = _g1_batch_to_mont(a_points, dev)
    bx, by = _g1_batch_to_mont(b_points, dev)
    (A1, B1), (A2, B2) = s1.tensors(dev), s2.tensors(dev)
    f = _miller(torch.stack([ax, bx], 1), torch.stack([ay, by], 1),
                torch.stack([A1, A2], -1).unsqueeze(-1),
                torch.stack([B1, B2], -1).unsqueeze(-1), s1.is_add)
    ok = f12_is_one(final_exp_batch(f12_mul(f[..., 0, :], f[..., 1, :])))
    return ok if lazy else ok.cpu().numpy()


def pairing_batch(p_points, q: "host.G2", device=None):
    """Batched full pairings e(P_i, Q) as a device Fp12 (K, 2, 3, 2,
    batch) tensor — the differential surface against the host.  On the
    card two kernel launches, their canonical words then converted to
    the limb layout; on the CPU the plain version."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return pairing_batch_plain(p_points, q, dev)
    _device.require_exact_fp32()          # the conversion's limb products
    PASSES[dev.type] += 1
    sched = line_schedule(q)
    f = cuda.miller(_device.upload(cuda.point_words(p_points)[None], dev),
                    _device.upload(sched.line_words()[None], dev),
                    _device.upload(sched.is_add.astype(np.int32), dev))
    return cuda.f12_from_words(cuda.final_exp(f, check=False))


def pairing_batch_plain(p_points, q: "host.G2", device=None):
    """`pairing_batch` as plain torch ops on any device."""
    dev = _device.resolve(device)
    _device.require_exact_fp32()
    PASSES[dev.type] += 1
    xs, ys = _g1_batch_to_mont(p_points, dev)
    return final_exp_batch(miller_batch(xs, ys, line_schedule(q)))


def f12_to_host(dev_f12, index: int = 0) -> "host.Fp12":
    """One batch element of a device Fp12 -> host Fp12."""
    canon = limbs.canonical(dev_f12[..., index], SPEC).cpu().numpy()
    r_inv = pow(_R, -1, host.P)

    def fp2(i, h):
        return host.Fp2(*(limbs.limbs_to_int(canon[:, j, i, h]) * r_inv
                          for j in range(2)))
    return host.Fp12(host.Fp6(fp2(0, 0), fp2(1, 0), fp2(2, 0)),
                     host.Fp6(fp2(0, 1), fp2(1, 1), fp2(2, 1)))
