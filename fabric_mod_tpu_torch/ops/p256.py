"""Batched ECDSA-P256 verification in PyTorch.

The port of fabric_mod_tpu/ops/p256.py.  Field arithmetic is the f32
limb layer (ops/limbs9.py, (K, batch) tensors); point arithmetic is the
Renes-Costello-Batina complete formulas for a = -3 (eprint 2015/1060,
algorithms 4, 5 and 6), transcribed in the reference's exact operation
order so every intermediate is the same field value.

`u1*G + u2*Q` is the 4-bit windowed Shamir ladder.  `shamir_ladder` and
`shamir_ladder_mixed` here are its PLAIN versions (any device), and
`verify_prologue_plain` / `verify_epilogue_plain` the plain versions of
the scalar prologue (w = s^-1, u1, u2 mod n, their windows, the key
check) and the epilogue.  `batch_verify` packs its inputs into one
buffer (ops/p256_core.py) and runs prologue, ladder and epilogue
through their wrappers (ops/p256_core.py, ops/p256_cuda.py): the
hand-written CUDA kernels for a CUDA buffer, the plain versions only
for a CPU one.  The final comparison avoids an inversion: accept iff
X == (r + k*n)*Z (mod p) for k in {0, 1} (with r + k*n < p), Z != 0.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from fabric_mod_tpu_torch import device as _device
from fabric_mod_tpu_torch.ops import limbs9 as limbs
from fabric_mod_tpu_torch.ops.limbs9 import (
    FieldSpec, K, add, sub, mont_mul, mont_sqr, to_mont, eq_zero,
    mul_small, canonical, bits_le, inv_mont, inv_mont_many,
    const_like,
)

WINDOW = 4                     # Shamir ladder window width (bits)
N_WINDOWS = 256 // WINDOW
TABLE = 1 << WINDOW

# --- Curve constants (NIST P-256 / secp256r1) ------------------------------
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5


def _affine_add(p1, p2):
    """Host-side python-int affine addition (table precompute only)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1 - 3) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g_multiples():
    """[G, 2G, ..., 15G] as affine python-int pairs."""
    out, acc = [], None
    for _ in range(1, TABLE):
        acc = _affine_add(acc, (GX, GY))
        out.append(acc)
    return out


@functools.lru_cache(maxsize=None)
def _consts():
    """Field specs and Montgomery-domain curve params (numpy)."""
    fp = FieldSpec.make("p256.p", P)
    fn = FieldSpec.make("p256.n", N)
    R = 1 << limbs.RBITS
    b_m = limbs.int_to_limbs((B * R) % P)
    gx_m = limbs.int_to_limbs((GX * R) % P)
    gy_m = limbs.int_to_limbs((GY * R) % P)
    return fp, fn, b_m, gx_m, gy_m


@functools.lru_cache(maxsize=None)
def _g_table():
    """(3, TABLE, K) numpy: projective Montgomery-domain [inf, G, ..., 15G]."""
    R = 1 << limbs.RBITS
    one_m = limbs.int_to_limbs(R % P)
    zero = np.zeros(K, np.float32)
    xs, ys, zs = [zero], [one_m.copy()], [zero.copy()]
    for x, y in g_multiples():
        xs.append(limbs.int_to_limbs(x * R % P))
        ys.append(limbs.int_to_limbs(y * R % P))
        zs.append(one_m.copy())
    return np.stack([np.stack(xs), np.stack(ys), np.stack(zs)])


@functools.lru_cache(maxsize=None)
def _g_table_affine():
    """(2, TABLE-1, K) numpy: affine Montgomery-domain [G, ..., 15G]."""
    R = 1 << limbs.RBITS
    pts = g_multiples()
    return np.stack([np.stack([limbs.int_to_limbs(x * R % P) for x, _ in pts]),
                     np.stack([limbs.int_to_limbs(y * R % P) for _, y in pts])])


# --- Complete point formulas (RCB, a = -3), Montgomery domain ---------------

def point_add(p1, p2, fp: FieldSpec, b_m: torch.Tensor):
    """Complete projective addition (RCB alg. 4): 12 muls + 2 by b."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    t0 = mont_mul(X1, X2, fp)
    t1 = mont_mul(Y1, Y2, fp)
    t2 = mont_mul(Z1, Z2, fp)
    t3 = add(X1, Y1)
    t4 = add(X2, Y2)
    t3 = mont_mul(t3, t4, fp)
    t4 = add(t0, t1)
    t3 = sub(t3, t4)
    t4 = add(Y1, Z1)
    X3 = add(Y2, Z2)
    t4 = mont_mul(t4, X3, fp)
    X3 = add(t1, t2)
    t4 = sub(t4, X3)
    X3 = add(X1, Z1)
    Y3 = add(X2, Z2)
    X3 = mont_mul(X3, Y3, fp)
    Y3 = add(t0, t2)
    Y3 = sub(X3, Y3)
    Z3 = mont_mul(b_m, t2, fp)
    X3 = sub(Y3, Z3)
    Z3 = add(X3, X3)
    X3 = add(X3, Z3)
    Z3 = sub(t1, X3)
    X3 = add(t1, X3)
    Y3 = mont_mul(b_m, Y3, fp)
    t1 = add(t2, t2)
    t2 = add(t1, t2)
    Y3 = sub(Y3, t2)
    Y3 = sub(Y3, t0)
    t1 = add(Y3, Y3)
    Y3 = add(t1, Y3)
    t1 = add(t0, t0)
    t0 = add(t1, t0)
    t0 = sub(t0, t2)
    t1 = mont_mul(t4, Y3, fp)
    t2 = mont_mul(t0, Y3, fp)
    Y3 = mont_mul(X3, Z3, fp)
    Y3 = add(Y3, t2)
    X3 = mont_mul(t3, X3, fp)
    X3 = sub(X3, t1)
    Z3 = mont_mul(t4, Z3, fp)
    t1 = mont_mul(t3, t0, fp)
    Z3 = add(Z3, t1)
    return (X3, Y3, Z3)


def point_add_mixed(p1, p2, fp: FieldSpec, b_m: torch.Tensor):
    """Complete mixed addition (RCB alg. 5): p2 affine (Z2 = 1)."""
    X1, Y1, Z1 = p1
    X2, Y2 = p2
    t0 = mont_mul(X1, X2, fp)
    t1 = mont_mul(Y1, Y2, fp)
    t3 = add(X2, Y2)
    t4 = add(X1, Y1)
    t3 = mont_mul(t3, t4, fp)
    t4 = add(t0, t1)
    t3 = sub(t3, t4)
    t4 = mont_mul(Y2, Z1, fp)
    t4 = add(t4, Y1)
    Y3 = mont_mul(X2, Z1, fp)
    Y3 = add(Y3, X1)
    Z3 = mont_mul(b_m, Z1, fp)
    X3 = sub(Y3, Z3)
    Z3 = add(X3, X3)
    X3 = add(X3, Z3)
    Z3 = sub(t1, X3)
    X3 = add(t1, X3)
    Y3 = mont_mul(b_m, Y3, fp)
    t1 = add(Z1, Z1)
    t2 = add(t1, Z1)
    Y3 = sub(Y3, t2)
    Y3 = sub(Y3, t0)
    t1 = add(Y3, Y3)
    Y3 = add(t1, Y3)
    t1 = add(t0, t0)
    t0 = add(t1, t0)
    t0 = sub(t0, t2)
    t1 = mont_mul(t4, Y3, fp)
    t2 = mont_mul(t0, Y3, fp)
    Y3 = mont_mul(X3, Z3, fp)
    Y3 = add(Y3, t2)
    X3 = mont_mul(t3, X3, fp)
    X3 = sub(X3, t1)
    Z3 = mont_mul(t4, Z3, fp)
    t1 = mont_mul(t3, t0, fp)
    Z3 = add(Z3, t1)
    return (X3, Y3, Z3)


def point_double(p, fp: FieldSpec, b_m: torch.Tensor):
    """Complete projective doubling (RCB alg. 6): 3 sqr + 8 muls + 2 by b."""
    X, Y, Z = p
    t0 = mont_sqr(X, fp)
    t1 = mont_sqr(Y, fp)
    t2 = mont_sqr(Z, fp)
    t3 = mont_mul(X, Y, fp)
    t3 = add(t3, t3)
    Z3 = mont_mul(X, Z, fp)
    Z3 = add(Z3, Z3)
    Y3 = mont_mul(b_m, t2, fp)
    Y3 = sub(Y3, Z3)
    X3 = add(Y3, Y3)
    Y3 = add(X3, Y3)
    X3 = sub(t1, Y3)
    Y3 = add(t1, Y3)
    Y3 = mont_mul(X3, Y3, fp)
    X3 = mont_mul(X3, t3, fp)
    t3 = add(t2, t2)
    t2 = add(t2, t3)
    Z3 = mont_mul(b_m, Z3, fp)
    Z3 = sub(Z3, t2)
    Z3 = sub(Z3, t0)
    t3 = add(Z3, Z3)
    Z3 = add(Z3, t3)
    t3 = add(t0, t0)
    t0 = add(t3, t0)
    t0 = sub(t0, t2)
    t0 = mont_mul(t0, Z3, fp)
    Y3 = add(Y3, t0)
    t0 = mont_mul(Y, Z, fp)
    t0 = add(t0, t0)
    Z3 = mont_mul(t0, Z3, fp)
    X3 = sub(X3, Z3)
    Z3 = mont_mul(t0, t1, fp)
    Z3 = add(Z3, Z3)
    Z3 = add(Z3, Z3)
    return (X3, Y3, Z3)


def infinity(like: torch.Tensor) -> tuple:
    """The projective identity (0 : 1 : 0) shaped like `like` (K, ...)."""
    fp = _consts()[0]
    zero = torch.zeros_like(like)
    one = const_like(fp.one_mont, like).expand_as(like).clone()
    return (zero, one, zero.clone())


def on_curve(xm: torch.Tensor, ym: torch.Tensor) -> torch.Tensor:
    """y^2 == x^3 - 3x + b (mod p) for Montgomery-domain affine coords."""
    fp, _, b_m, _, _ = _consts()
    y2 = mont_sqr(ym, fp)
    x2 = mont_sqr(xm, fp)
    x3 = mont_mul(x2, xm, fp)
    rhs = add(sub(x3, mul_small(xm, 3)), const_like(b_m, xm))
    return eq_zero(sub(y2, rhs), fp)


def build_q_table(q1, inf_pt, fp: FieldSpec, b_m):
    """[inf, Q, 2Q, ..., 15Q] — the per-lane window table schedule (7
    doublings + 7 additions), shared with the CUDA kernels."""
    qtab = [inf_pt, q1]
    for i in range(2, TABLE):
        if i % 2 == 0:
            qtab.append(point_double(qtab[i // 2], fp, b_m))
        else:
            qtab.append(point_add(qtab[i - 1], q1, fp, b_m))
    return qtab


def _select(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(T, K, batch) per-lane table, (batch,) index -> (K, batch)."""
    g = idx.to(torch.int64).reshape(1, 1, -1).expand(1, table.shape[1], -1)
    return torch.gather(table, 0, g)[0]


def _gselect(g_plane: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """(T, K) constant table, (batch,) index -> (K, batch)."""
    t = limbs.const(g_plane, idx.device)
    return t[idx.to(torch.int64)].T


def shamir_ladder(u1_w: torch.Tensor, u2_w: torch.Tensor,
                  qx_m: torch.Tensor, qy_m: torch.Tensor):
    """The PLAIN windowed Shamir ladder: u1*G + u2*Q from MSB-first
    window values (N_WINDOWS, batch) and the Montgomery-domain affine
    key (K, batch).  Returns the projective (X, Y, Z)."""
    fp, _fn, b_m_np, _, _ = _consts()
    b_m = const_like(b_m_np, qx_m)
    inf = infinity(qx_m)
    qtab = build_q_table((qx_m, qy_m, inf[1]), inf, fp, b_m)
    q_table = tuple(torch.stack([pt[c] for pt in qtab], dim=0)
                    for c in range(3))                # (TABLE, K, batch)
    acc = infinity(qx_m)
    for w in range(N_WINDOWS):
        for _ in range(WINDOW):
            acc = point_double(acc, fp, b_m)
        acc = point_add(acc, tuple(_select(q_table[c], u2_w[w])
                                   for c in range(3)), fp, b_m)
        acc = point_add(acc, tuple(_gselect(_g_planes(c), u1_w[w])
                                   for c in range(3)), fp, b_m)
    return acc


@functools.lru_cache(maxsize=None)
def _g_planes(c: int) -> np.ndarray:
    return np.ascontiguousarray(_g_table()[c])


@functools.lru_cache(maxsize=None)
def _g_planes_affine(c: int) -> np.ndarray:
    return np.ascontiguousarray(_g_table_affine()[c])


def build_q_table_affine(qx_m, qy_m, fp: FieldSpec, b_m, inv=None):
    """[Q, 2Q, ..., 15Q] as AFFINE Montgomery-domain (x, y) lists:
    the shared projective schedule normalised by ONE simultaneous
    inversion.  Lanes with an invalid key can reach Z = 0; the
    inversion then zeroes that lane's table (masked by key_ok)."""
    inf = infinity(qx_m)
    qtab = build_q_table((qx_m, qy_m, inf[1]), inf, fp, b_m)[1:]
    zinv = inv_mont_many([pt[2] for pt in qtab], fp, inv=inv)
    ax = [mont_mul(pt[0], zi, fp) for pt, zi in zip(qtab, zinv)]
    ay = [mont_mul(pt[1], zi, fp) for pt, zi in zip(qtab, zinv)]
    return ax, ay


def shamir_ladder_mixed(u1_w: torch.Tensor, u2_w: torch.Tensor,
                        qx_m: torch.Tensor, qy_m: torch.Tensor):
    """The PLAIN affine-table ladder with complete mixed additions; zero
    windows keep the accumulator.  Same contract as `shamir_ladder`
    (identical verdicts; the representative differs by a Z scale)."""
    fp, _fn, b_m_np, _, _ = _consts()
    b_m = const_like(b_m_np, qx_m)
    ax, ay = build_q_table_affine(qx_m, qy_m, fp, b_m)
    q_tab = (torch.stack(ax, dim=0), torch.stack(ay, dim=0))

    def add_selected(acc, w, p2):
        added = point_add_mixed(acc, p2, fp, b_m)
        keep = (w == 0)[None]
        return tuple(torch.where(keep, a, n) for a, n in zip(acc, added))

    acc = infinity(qx_m)
    for w in range(N_WINDOWS):
        for _ in range(WINDOW):
            acc = point_double(acc, fp, b_m)
        w2 = u2_w[w]
        i2 = (w2.to(torch.int64) - 1).clamp(min=0)
        acc = add_selected(acc, w2, tuple(_select(q_tab[c], i2)
                                          for c in range(2)))
        w1 = u1_w[w]
        i1 = (w1.to(torch.int64) - 1).clamp(min=0)
        acc = add_selected(acc, w1, tuple(_gselect(_g_planes_affine(c), i1)
                                          for c in range(2)))
    return acc


def inv_mont_p_chain(a_mont: torch.Tensor, spec=None) -> torch.Tensor:
    """Fermat inversion mod p via P-256's fixed addition chain for p-2
    (255 squarings + 13 multiplies).  `spec`, if given, must be the p
    field."""
    fp = _consts()[0]
    if spec is not None and spec.modulus != P:
        raise ValueError("inv_mont_p_chain is specific to the P-256 p field")

    def sqr_n(x, n):
        for _ in range(n):
            x = mont_sqr(x, fp)
        return x

    a = a_mont
    x2 = mont_mul(mont_sqr(a, fp), a, fp)            # a^(2^2 - 1)
    x4 = mont_mul(sqr_n(x2, 2), x2, fp)              # a^(2^4 - 1)
    x8 = mont_mul(sqr_n(x4, 4), x4, fp)              # a^(2^8 - 1)
    x16 = mont_mul(sqr_n(x8, 8), x8, fp)             # a^(2^16 - 1)
    x24 = mont_mul(sqr_n(x16, 8), x8, fp)            # a^(2^24 - 1)
    x28 = mont_mul(sqr_n(x24, 4), x4, fp)            # a^(2^28 - 1)
    x30 = mont_mul(sqr_n(x28, 2), x2, fp)            # a^(2^30 - 1)
    x32 = mont_mul(sqr_n(x30, 2), x2, fp)            # a^(2^32 - 1)
    acc = mont_mul(sqr_n(x32, 32), a, fp)            # FFFFFFFF 00000001
    acc = sqr_n(acc, 96)                             # three zero words
    acc = mont_mul(sqr_n(acc, 32), x32, fp)          # FFFFFFFF
    acc = mont_mul(sqr_n(acc, 32), x32, fp)          # FFFFFFFF
    acc = mont_mul(sqr_n(acc, 30), x30, fp)          # FFFFFFFD ...
    acc = mont_mul(sqr_n(acc, 2), a, fp)             # ... = (2^30-1)*4+1
    return acc


def digest_words_le(dw: torch.Tensor) -> torch.Tensor:
    """(batch, 8) big-endian SHA-256 digest words (int64, < 2^32) ->
    (8, batch) int32 bit patterns of the digest's little-endian words:
    the verify core's e rows (ops/p256_core.py)."""
    from fabric_mod_tpu_torch.ops import p256_cuda
    return p256_cuda.to_u32_bits(dw.to(torch.int64).flip(-1).T)


def windows_msb_first(u_canon: torch.Tensor) -> torch.Tensor:
    """Canonical int32 limbs (K, batch) -> (N_WINDOWS, batch) int32
    4-bit window values, most significant window first."""
    bits = bits_le(u_canon)                          # (256, batch)
    wexp = (1 << torch.arange(WINDOW, device=bits.device,
                              dtype=torch.int32)).reshape(1, WINDOW, 1)
    w = (bits.reshape((N_WINDOWS, WINDOW) + tuple(bits.shape[1:]))
         * wexp).sum(1).to(torch.int32)
    return w.flip(0)


def verify_prologue_plain(e, r, s, qx, qy):
    """The PLAIN verify prologue (the CUDA kernel's plain version, see
    ops/p256_core.py): scalars mod n and the key check.

    e, r, s, qx, qy: (K, batch) f32 canonical limbs of the digest (any
    256-bit value), the signature scalars and the affine key.  Returns
    (u1_w, u2_w, qx_m, qy_m, key_ok): the (N_WINDOWS, batch) int32
    window planes of u1 = e*w and u2 = r*w mod n (w = s^-1 mod n), most
    significant window first; the key in Montgomery form mod p; and
    (batch,) bool key_ok — the key is on the curve and is not (0, 0)."""
    fp, fn, _b_m_np, _, _ = _consts()
    qx_m = to_mont(qx, fp)
    qy_m = to_mont(qy, fp)
    key_ok = on_curve(qx_m, qy_m)
    key_ok &= ~(eq_zero(qx, fp) & eq_zero(qy, fp))
    # mont_mul of a plain value by a Montgomery-domain one is the plain
    # product
    w_mn = inv_mont(to_mont(s, fn), fn)
    u1 = canonical(mont_mul(e, w_mn, fn), fn)
    u2 = canonical(mont_mul(r, w_mn, fn), fn)
    return windows_msb_first(u1), windows_msb_first(u2), qx_m, qy_m, key_ok


def verify_epilogue_plain(X, Z, r, rn_lt_p, key_ok) -> torch.Tensor:
    """The PLAIN verify epilogue: accept iff the key is good, Z != 0 and
    X == r'*Z (mod p) for r' in {r, r + n} (r + n only where rn_lt_p).
    X, Z: (K, batch) Montgomery-domain limbs of the ladder's output;
    r: (K, batch) canonical limbs.  Returns (batch,) bool."""
    fp, fn, _b_m_np, _, _ = _consts()
    not_inf = ~eq_zero(Z, fp)
    r_m = to_mont(r, fp)
    ok_r = eq_zero(sub(X, mont_mul(r_m, Z, fp)), fp)
    rn = add(r, const_like(fn.p, r))
    rn_m = to_mont(rn, fp)
    ok_rn = eq_zero(sub(X, mont_mul(rn_m, Z, fp)), fp) & rn_lt_p
    return key_ok & not_inf & (ok_r | ok_rn)


# --- Host wrapper ----------------------------------------------------------

_N_BYTES = N.to_bytes(32, "big")
_P_BYTES = P.to_bytes(32, "big")
_P_MINUS_N_BYTES = (P - N).to_bytes(32, "big")


def _lt_bytes(a: np.ndarray, b_: bytes) -> np.ndarray:
    """Lexicographic a < b over (..., 32) big-endian byte arrays."""
    bb = np.frombuffer(b_, np.uint8)
    diff = a.astype(np.int16) - bb.astype(np.int16)
    nz = diff != 0
    first = np.argmax(nz, axis=-1)
    any_nz = nz.any(axis=-1)
    firstval = np.take_along_axis(diff, first[..., None], axis=-1)[..., 0]
    return np.where(any_nz, firstval < 0, False)


def range_checks(digests, r_bytes, s_bytes, qx_bytes, qy_bytes):
    """The five (batch, 32) uint8 big-endian planes, the host-side
    scalar-range verdict (r, s in [1, n), qx, qy < p) and rn_lt_p
    (r + n < p)."""
    planes = tuple(np.asarray(a, np.uint8) for a in
                   (digests, r_bytes, s_bytes, qx_bytes, qy_bytes))
    _d, r, s, qx, qy = planes
    range_ok = (r.any(axis=-1) & s.any(axis=-1)
                & _lt_bytes(r, _N_BYTES) & _lt_bytes(s, _N_BYTES)
                & _lt_bytes(qx, _P_BYTES) & _lt_bytes(qy, _P_BYTES))
    return planes, range_ok, _lt_bytes(r, _P_MINUS_N_BYTES)


def _core(e, buf, mixed: bool, lazy: bool):
    """Prologue, ladder and epilogue on the packed buffer's device: the
    CUDA kernels for a CUDA buffer, their plain versions for a CPU one."""
    from fabric_mod_tpu_torch.ops import p256_core, p256_cuda
    u1_w, u2_w, key_ok = p256_core.prologue(e, buf)
    X, _Y, Z = p256_cuda.ladder_words(
        u1_w, u2_w, p256_core.rows(buf, p256_core.ROW_QX),
        p256_core.rows(buf, p256_core.ROW_QY), mixed)
    ok = p256_core.epilogue(X, Z, buf, key_ok)
    return ok if lazy else ok.cpu().numpy()


def _packed(dev, digests, r_bytes, s_bytes, qx_bytes, qy_bytes, pre_ok,
            has_msg=None):
    """The core's packed input buffer on `dev`, in one copy."""
    from fabric_mod_tpu_torch.ops import p256_core
    if dev.type == "cuda":
        _device.require_exact_fp32()
    planes, range_ok, rn_lt_p = range_checks(
        digests, r_bytes, s_bytes, qx_bytes, qy_bytes)
    n = len(range_ok)
    pre_ok = np.ones(n, bool) if pre_ok is None else np.asarray(pre_ok, bool)
    return _device.upload(
        p256_core.pack(planes, range_ok, pre_ok, rn_lt_p, has_msg), dev)


def batch_verify(digests, r_bytes, s_bytes, qx_bytes, qy_bytes,
                 device=None, mixed: bool = False, lazy: bool = False,
                 pre_ok=None):
    """Verify a batch of ECDSA-P256 signatures over 32-byte digests.

    All args are (batch, 32) uint8 big-endian; `pre_ok`, if given, the
    (batch,) host validity mask (False lanes never verify).  Runs on
    CUDA unless `device="cpu"`: the inputs go to the device in one copy
    and the core is three launches there (ops/p256_core.py prologue,
    the ladder, the epilogue).  Returns (batch,) bool numpy — or, with
    `lazy=True`, the (batch,) bool verdict tensor on the device, its
    work enqueued and not waited for (CUDA is asynchronous)."""
    from fabric_mod_tpu_torch.ops import p256_core
    buf = _packed(_device.resolve(device), digests, r_bytes, s_bytes,
                  qx_bytes, qy_bytes, pre_ok)
    return _core(p256_core.rows(buf, p256_core.ROW_E), buf, mixed, lazy)


def batch_verify_raw(words, nblocks, has_msg, digests, r_bytes, s_bytes,
                     qx_bytes, qy_bytes, device=None, mixed: bool = False,
                     lazy: bool = False, pre_ok=None):
    """`batch_verify` with the digest computed on the device for raw-
    message lanes (`words`: (batch, max_blocks, 16) uint32 from
    bccsp/der.pack_messages, `nblocks` their real block counts); lanes
    with has_msg False use `digests`.  The words go to the device in one
    pinned copy, as int32 bit patterns; ops/sha256.sha256_e then writes
    each raw lane's digest into the packed buffer's e rows in front of
    the prologue: on CUDA a raw call is four launches (SHA-256,
    prologue, ladder, epilogue)."""
    from fabric_mod_tpu_torch.ops import p256_core, sha256
    dev = _device.resolve(device)
    buf = _packed(dev, digests, r_bytes, s_bytes, qx_bytes, qy_bytes,
                  pre_ok, has_msg)
    w = _device.upload(np.asarray(words, np.uint32).view(np.int32), dev)
    nb = _device.upload(np.asarray(nblocks, np.int32), dev)
    sha256.sha256_e(w, nb, buf)
    return _core(p256_core.rows(buf, p256_core.ROW_E), buf, mixed, lazy)
