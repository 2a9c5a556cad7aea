"""f32 radix-2^9 modular arithmetic in plain PyTorch — the limb layer.

The port of fabric_mod_tpu/ops/limbs9.py.  A field element is K = 30
float32 limbs of B = 9 bits with the limb axis FIRST — (K, *batch)
tensors — in Montgomery form with R = 2^270.  The schoolbook column
fold and both Montgomery constant products are float32 matmuls.

Exactness (do not change K/B casually; the bounds are the reference's):

* ``carried`` uses rounded carries, so limbs stay within |limb| <= 273;
  products are < 2^16.2 and column sums < 2^22.2 — every value is an
  integer well inside the 24-bit f32 mantissa, so a full-precision
  float32 matmul is exact whatever order it sums in.
* That holds only without TF32.  device.require_exact_fp32() pins it on
  every CUDA entry point; a TF32 matmul would make verdicts wrong with
  no error.
* Carries that must be sequential (the Montgomery low carry and
  canonicalisation) run in int64 over radix-2^36 digits (four limbs
  each) instead of limb by limb: floor carries compose, so the result
  is the same integer the reference's 30-step float chain produces, in
  8 steps.

This is the plain version the kernels of ops/p256_cuda.py are held
against; on the card it runs as ordinary PyTorch ops.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

K = 30            # number of limbs
B = 9             # bits per limb
BASE = 1 << B     # 512
MASK = BASE - 1
RBITS = K * B     # 270

_F = torch.float32

# radix-2^36 digit view used by the sequential carries: 7 digits of 4
# limbs + 1 digit of the top 2 limbs
_NDIG = 8
_DIG_BITS = [36] * 7 + [18]


# ---------------------------------------------------------------------------
# Host-side converters (numpy; trailing limb axis)
# ---------------------------------------------------------------------------

def int_to_limbs(x: int) -> np.ndarray:
    """Non-negative python int (< 2**RBITS) -> (K,) float32 limbs."""
    if not 0 <= x < (1 << RBITS):
        raise ValueError("value out of limb range")
    out = np.zeros(K, np.float32)
    for i in range(K):
        out[i] = x & MASK
        x >>= B
    return out


def limbs_to_int(a) -> int:
    """Exact value of a (possibly lazy, signed) (K,) limb vector."""
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    if a.ndim != 1 or a.shape[0] != K:
        raise ValueError("expected a (K,) limb vector")
    return sum(int(v) << (B * i) for i, v in enumerate(a.tolist()))


def be_bytes_to_limbs(buf: np.ndarray) -> np.ndarray:
    """(..., 32) uint8 big-endian -> (..., K) int32 limbs (host-side)."""
    buf = np.asarray(buf, np.uint8)
    if buf.shape[-1] != 32:
        raise ValueError("expected 32-byte rows")
    bits = np.unpackbits(buf[..., ::-1], axis=-1, bitorder="little")
    pad = np.zeros(bits.shape[:-1] + (RBITS - 256,), np.uint8)
    bits = np.concatenate([bits, pad], axis=-1)
    bits = bits.reshape(bits.shape[:-1] + (K, B))
    weights = (1 << np.arange(B)).astype(np.int32)
    return (bits.astype(np.int32) * weights).sum(-1).astype(np.int32)


def to_device(host_limbs: np.ndarray, device) -> torch.Tensor:
    """(..., K) host limbs -> (K, ...) f32 device layout."""
    return torch.as_tensor(
        np.ascontiguousarray(np.moveaxis(np.asarray(host_limbs), -1, 0)),
        dtype=_F, device=device)


# ---------------------------------------------------------------------------
# Field specification (per modulus)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Montgomery constants for one odd modulus (R = 2^270), numpy."""
    name: str
    modulus: int
    p: np.ndarray          # (K,) f32 canonical limbs of p
    one: np.ndarray        # (K,) f32 limbs of 1
    one_mont: np.ndarray   # (K,) f32 R mod p
    r2: np.ndarray         # (K,) f32 R^2 mod p
    np_mat: np.ndarray     # (K, K) f32: m = np_mat @ t_low  (x*N' mod R)
    p_mat: np.ndarray      # (2K-1, K) f32: full columns of m*p
    kp32: np.ndarray       # (6, K) int32 canonical limbs of 32p..p
    lift32: np.ndarray     # (K,) int32 canonical limbs of 32p

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def make(name: str, modulus: int) -> "FieldSpec":
        R = 1 << RBITS
        nprime = (-pow(modulus, -1, R)) % R
        p_l = int_to_limbs(modulus)
        np_l = int_to_limbs(nprime)
        np_mat = np.zeros((K, K), np.float32)
        p_mat = np.zeros((2 * K - 1, K), np.float32)
        for c in range(K):
            for j in range(c + 1):
                np_mat[c, j] = np_l[c - j]
        for c in range(2 * K - 1):
            for j in range(K):
                if 0 <= c - j < K:
                    p_mat[c, j] = p_l[c - j]
        kps = [int_to_limbs((32 >> i) * modulus).astype(np.int32)
               for i in range(6)]
        return FieldSpec(
            name=name, modulus=modulus, p=p_l,
            one=int_to_limbs(1),
            one_mont=int_to_limbs(R % modulus),
            r2=int_to_limbs((R * R) % modulus),
            np_mat=np_mat, p_mat=p_mat,
            kp32=np.stack(kps), lift32=kps[0],
        )


# ---------------------------------------------------------------------------
# Constants on a device
# ---------------------------------------------------------------------------

class _ConstCache:
    """numpy constant -> tensor on one device, made once.  Keyed by the
    array's identity; the array itself is kept alive in the entry so an
    id can never be reused by another array."""

    def __init__(self):
        self._d: dict = {}

    def get(self, arr: np.ndarray, device, dtype=None) -> torch.Tensor:
        key = (id(arr), str(device), dtype)
        hit = self._d.get(key)
        if hit is None:
            t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
            if dtype is not None:
                t = t.to(dtype)
            hit = self._d[key] = (arr, t)
        return hit[1]


_CONSTS = _ConstCache()


def const(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    return _CONSTS.get(arr, device, dtype)


def const_dot(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(rows, cols) constant @ (cols, *batch) -> (rows, *batch), as one
    float32 matmul (exact: see the module docstring)."""
    m = const(mat, x.device)
    out = torch.matmul(m, x.reshape(x.shape[0], -1))
    return out.reshape((m.shape[0],) + tuple(x.shape[1:]))


def const_like(c: np.ndarray, a: torch.Tensor) -> torch.Tensor:
    """(K,) constant -> (K, 1, ..., 1) matching a's rank."""
    return const(c, a.device).reshape((K,) + (1,) * (a.dim() - 1))


def _align2(a: torch.Tensor, b: torch.Tensor):
    """Rank-align a bare (K,) operand against a (K, batch...) one."""
    if a.dim() < b.dim():
        a = a.reshape(tuple(a.shape) + (1,) * (b.dim() - a.dim()))
    elif b.dim() < a.dim():
        b = b.reshape(tuple(b.shape) + (1,) * (a.dim() - b.dim()))
    return a, b


# ---------------------------------------------------------------------------
# Carries
# ---------------------------------------------------------------------------

def _carry_pass(x: torch.Tensor, keep_top: bool) -> torch.Tensor:
    """One rounded carry pass: x = hi*BASE + lo, lo in [-BASE/2, BASE/2];
    hi moves up one limb.  keep_top: the top limb is not split."""
    hi = torch.floor(x * (1.0 / BASE) + 0.5)
    lo = x - hi * BASE
    if keep_top:
        lo[-1] = x[-1]
    lo[1:] += hi[:-1]
    return lo


def carried(x: torch.Tensor) -> torch.Tensor:
    """Two rounded carry passes preserving the exact value; the top limb
    is never split."""
    return _carry_pass(_carry_pass(x, True), True)


def carry_mod_r(x: torch.Tensor) -> torch.Tensor:
    """Two rounded passes over exactly K limbs, dropping overflow (mod R)."""
    return _carry_pass(_carry_pass(x, False), False)


def _digits36(x: torch.Tensor) -> torch.Tensor:
    """(K, *batch) int64 limbs -> (8, *batch) int64 radix-2^36 digits of
    the same value (digits may be out of range; no carry is done)."""
    rest = tuple(x.shape[1:])
    w4 = torch.tensor([1, 1 << 9, 1 << 18, 1 << 27], dtype=torch.int64,
                      device=x.device).reshape((1, 4) + (1,) * len(rest))
    low = (x[:28].reshape((7, 4) + rest) * w4).sum(1)
    top = x[28] + x[29] * BASE
    return torch.cat([low, top[None]], dim=0)


def _exact_low_carry(s: torch.Tensor) -> torch.Tensor:
    """Exact carry out of the low K limbs of s (value ≡ 0 mod R):
    floor(sum_i s_i 2^(9i) / 2^270), the same integer as the reference's
    limb-by-limb float chain."""
    d = _digits36(s[:K].to(torch.int64))
    c = torch.zeros_like(d[0])
    for g in range(_NDIG):
        c = (d[g] + c) >> _DIG_BITS[g]
    return c.to(_F)


# ---------------------------------------------------------------------------
# Schoolbook + Montgomery
# ---------------------------------------------------------------------------

# Anti-diagonal fold: flattened outer index (i*K+j) -> column i+j.
_COLSUM = np.zeros((2 * K - 1, K * K), np.float32)
for _i in range(K):
    for _j in range(K):
        _COLSUM[_i + _j, _i * K + _j] = 1.0

# Symmetric fold for squaring: upper-triangle products (i <= j) in the
# order [a_i*a_i, a_i*a_{i+1}, ..., a_i*a_{K-1}] for i = 0..K-1; cross
# terms carry weight 2.
_COLSUM_SQR = np.zeros((2 * K - 1, K * (K + 1) // 2), np.float32)
_TRI_I = np.zeros(K * (K + 1) // 2, np.int64)
_TRI_J = np.zeros(K * (K + 1) // 2, np.int64)
_idx = 0
for _i in range(K):
    for _j in range(_i, K):
        _COLSUM_SQR[_i + _j, _idx] = 1.0 if _i == _j else 2.0
        _TRI_I[_idx], _TRI_J[_idx] = _i, _j
        _idx += 1


def sb_mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns: (K, ...) x (K, ...) -> (2K-1, ...)."""
    outer = a[:, None] * b[None, :]                      # (K, K, ...)
    return const_dot(_COLSUM, outer.reshape((K * K,) + tuple(outer.shape[2:])))


def sb_sqr_cols(a: torch.Tensor) -> torch.Tensor:
    """Schoolbook square columns over the upper triangle (465 products)."""
    tri = a[const(_TRI_I, a.device)] * a[const(_TRI_J, a.device)]
    return const_dot(_COLSUM_SQR, tri)


def _mont_reduce(t: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery reduction of carried columns t -> t*R^-1 mod p."""
    m = carry_mod_r(const_dot(spec.np_mat, t[:K]))
    s = t + const_dot(spec.p_mat, m)              # low K limbs ≡ 0 mod R
    c = _exact_low_carry(s)
    hi = s[K:]                                    # (K-1, ...)
    hi = torch.cat([hi[:1] + c[None], hi[1:],
                    torch.zeros_like(hi[:1])], dim=0)   # (K, ...)
    return carried(hi)


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p (lazy limbs in and out)."""
    a, b = _align2(a, b)
    return _mont_reduce(carried(sb_mul_cols(a, b)), spec)


def mont_sqr(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Montgomery square via the symmetric schoolbook."""
    return _mont_reduce(carried(sb_sqr_cols(a)), spec)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align2(a, b)
    return carried(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align2(a, b)
    return carried(a - b)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small non-negative python int (k < 2**6)."""
    return carried(a * float(k))


def to_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return mont_mul(a, const_like(spec.r2, a), spec)


def from_mont(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    return mont_mul(a, const_like(spec.one, a), spec)


# ---------------------------------------------------------------------------
# Canonicalisation & comparisons (int64 digits, exact)
# ---------------------------------------------------------------------------

def _carry_digits(d: torch.Tensor) -> torch.Tensor:
    """Full sequential carry of radix-2^36 digits; value in [0, R)."""
    outs, c = [], torch.zeros_like(d[0])
    for g in range(_NDIG):
        t = d[g] + c
        outs.append(t & ((1 << _DIG_BITS[g]) - 1))
        c = t >> _DIG_BITS[g]
    return torch.stack(outs, dim=0)


def _geq_sub(v: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """If canonical v >= canonical kp: v - kp, else v (digit form)."""
    d = v - kp.reshape((_NDIG,) + (1,) * (v.dim() - 1))
    outs, borrow = [], torch.zeros_like(d[0])
    for g in range(_NDIG):
        t = d[g] + borrow
        outs.append(t & ((1 << _DIG_BITS[g]) - 1))
        borrow = t >> _DIG_BITS[g]                # 0 or -1
    return torch.where((borrow >= 0)[None], torch.stack(outs, dim=0), v)


@functools.lru_cache(maxsize=None)
def _kp_digits(modulus: int) -> np.ndarray:
    """32p, 16p, ..., p as (6, 8) radix-2^36 digit vectors (numpy)."""
    rows = []
    for i in range(6):
        v, row = (32 >> i) * modulus, []
        for w in _DIG_BITS:
            row.append(v & ((1 << w) - 1))
            v >>= w
        rows.append(row)
    return np.array(rows, np.int64)


_LIMB_DIGIT = np.arange(K) // 4
_LIMB_SHIFT = (np.arange(K) % 4) * B


def canonical(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Lazy f32 limbs (|value| < 2^260) -> canonical int32 limbs in [0, p).

    Lifts by 32p (sign removal), carries exactly, then six conditional
    subtractions of 32p..p."""
    x = a.to(torch.int64) + const_like(spec.lift32, a).to(torch.int64)
    v = _carry_digits(_digits36(x))
    kp = const(_kp_digits(spec.modulus), a.device)
    for i in range(6):
        v = _geq_sub(v, kp[i])
    rows = v[const(_LIMB_DIGIT, a.device)]
    shifts = const(_LIMB_SHIFT, a.device).reshape((K,) + (1,) * (a.dim() - 1))
    return ((rows >> shifts) & MASK).to(torch.int32)


def eq_zero(a: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Is lazy value ≡ 0 (mod p)?  (K, ...) -> (...) bool."""
    return (canonical(a, spec) == 0).all(dim=0)


def bits_le(canon_i32: torch.Tensor, nbits: int = 256) -> torch.Tensor:
    """Canonical int32 limbs (K, ...) -> (nbits, ...) bits, LSB first."""
    limb_idx = torch.arange(nbits, device=canon_i32.device) // B
    shifts = (torch.arange(nbits, device=canon_i32.device, dtype=torch.int32)
              % B).reshape((nbits,) + (1,) * (canon_i32.dim() - 1))
    return (canon_i32[limb_idx] >> shifts) & 1


# ---------------------------------------------------------------------------
# Words <-> limbs (the kernels' 8 x 32-bit little-endian form)
# ---------------------------------------------------------------------------

_W_Q = np.array([9 * i // 32 for i in range(K)], np.int64)
_W_OFF = np.array([9 * i % 32 for i in range(K)], np.int64)
_PAIRS = [(j, i, 9 * i - 32 * j) for j in range(8) for i in range(K)
          if 9 * i < 32 * j + 32 and 9 * i + 9 > 32 * j]
_PAIR_WORD = np.array([p[0] for p in _PAIRS], np.int64)
_PAIR_LIMB = np.array([p[1] for p in _PAIRS], np.int64)
_PAIR_LSH = np.array([max(p[2], 0) for p in _PAIRS], np.int64)
_PAIR_RSH = np.array([max(-p[2], 0) for p in _PAIRS], np.int64)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(8, *batch) int64 32-bit words, least significant first ->
    (K, *batch) int64 canonical 9-bit limbs of the same value."""
    rest = tuple(w.shape[1:])
    wp = torch.cat([w, torch.zeros((2,) + rest, dtype=w.dtype,
                                   device=w.device)], dim=0)
    dev = w.device
    shape = (K,) + (1,) * len(rest)
    q = const(_W_Q, dev)
    off = const(_W_OFF, dev).reshape(shape)
    lo = wp[q] >> off
    hi = (wp[q + 1] & MASK) << (32 - off)
    return (lo | hi) & MASK


def limbs_to_words(l: torch.Tensor) -> torch.Tensor:
    """(K, *batch) canonical limbs (any int dtype, values < 2^256) ->
    (8, *batch) int64 32-bit words, least significant first."""
    rest = tuple(l.shape[1:])
    dev = l.device
    shape = (len(_PAIRS),) + (1,) * len(rest)
    v = l.to(torch.int64)[const(_PAIR_LIMB, dev)]
    v = ((v << const(_PAIR_LSH, dev).reshape(shape))
         >> const(_PAIR_RSH, dev).reshape(shape)) & 0xFFFFFFFF
    out = torch.zeros((8,) + rest, dtype=torch.int64, device=dev)
    return out.index_add_(0, const(_PAIR_WORD, dev), v)


# ---------------------------------------------------------------------------
# Exponentiation
# ---------------------------------------------------------------------------

def pow_static(a_mont: torch.Tensor, exponent: int, spec: FieldSpec) -> torch.Tensor:
    """a^exponent in the Montgomery domain, static python-int exponent
    (square-and-multiply, MSB first; the multiply runs only where the
    exponent bit is set — the same values as the reference's select)."""
    acc = const_like(spec.one_mont, a_mont).expand_as(a_mont).clone()
    for bit in bin(max(exponent, 0))[2:]:
        acc = mont_sqr(acc, spec)
        if bit == "1":
            acc = mont_mul(acc, a_mont, spec)
    return acc


def inv_mont(a_mont: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """Modular inverse in the Montgomery domain (Fermat; p prime)."""
    return pow_static(a_mont, spec.modulus - 2, spec)


def inv_mont_many(vals, spec: FieldSpec, inv=None) -> list:
    """Montgomery's simultaneous-inversion trick: invert m values with
    ONE inversion plus 3(m-1) multiplies.  A zero value poisons every
    inverse of its lane (callers mask such lanes).  `inv` overrides the
    single inversion (default `inv_mont`)."""
    inv = inv or inv_mont
    m = len(vals)
    if m == 0:
        return []
    if m == 1:
        return [inv(vals[0], spec)]
    prefix = [vals[0]]
    for v in vals[1:]:
        prefix.append(mont_mul(prefix[-1], v, spec))
    running = inv(prefix[-1], spec)
    out = [None] * m
    for i in range(m - 1, 0, -1):
        out[i] = mont_mul(running, prefix[i - 1], spec)
        running = mont_mul(running, vals[i], spec)
    out[0] = running
    return out
