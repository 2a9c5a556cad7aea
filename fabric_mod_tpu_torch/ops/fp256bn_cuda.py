"""The idemix pairing check on the card: wrappers of the hand-written CUDA
kernels of csrc/fp256bn_pairing.cu.

Replaces the device program of fabric_mod_tpu/ops/fp256bn_dev.py that
the JAX package jits whole as `_check_fn` (:440): `miller_batch` (:339)
becomes `fp256bn_miller_kernel`; the pair product `f12_mul` (:179),
`final_exp_batch` (:397) and `f12_is_one` (:247) become
`fp256bn_final_exp_kernel`.  Their plain versions are `miller_plain` and
`final_exp_plain` here, over the torch ops of ops/fp256bn_dev.py.

Everything that crosses a kernel's boundary is canonical words: int32
tensors holding the bit patterns of 8 little-endian 32-bit words a value,
the lane axis last.  The G1 points are (S, 2, 8, n) (x, y of S schedules'
points), a schedule's line constants (S, n_main + 2, 4, 8) (A.a, A.b,
B.a, B.b a step, the two correction lines last), is_add (n_main,) int32,
and a Miller value or a pairing (S, 12, 8, n) or (12, 8, n), coefficient
c = 6h + 2i + j (w half h, Fp6 coefficient i, Fp2 component j).

`miller(pts, lines, is_add)` and `final_exp(f, check)` launch the kernels
for CUDA tensors and raise on any fault; for CPU tensors they ARE the
plain versions.  Each kernel has a launch count (`LAUNCHES`), raised by
one where the wrapper launches it and nowhere else.

`products_per_lane` is the reference's count of Fp products (a lane's);
`multiply_adds_per_lane` prices it beside the kernels' own count
(ops/fp256bn_programs.design_counts), the least of the two the bound's
work; `geometry` gives the kernels' threads a lane, lanes a block and
blocks an SM holds.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from fabric_mod_tpu_torch.idemix import fp256bn as host
from fabric_mod_tpu_torch.ops import fp256bn_programs
from fabric_mod_tpu_torch.ops import limbs9 as limbs
from fabric_mod_tpu_torch.ops import p256_cuda

# the limb layer's field (the same cached spec as ops/fp256bn_dev.SPEC)
SPEC = limbs.FieldSpec.make("fp256bn.p", host.P)

KERNELS = ("fp256bn_miller", "fp256bn_final_exp")
LAUNCHES = {name: 0 for name in KERNELS}

# a step's line constants, and an Fp12's coefficients
LINE_VALUES = 4
F12_COEFFS = 12


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict:
    return dict(LAUNCHES)


# --- words -------------------------------------------------------------------

def int_words(values) -> np.ndarray:
    """Python ints in [0, 2^256) -> (8, len) int32 bit patterns of their
    little-endian 32-bit words."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(buf, "<u4").reshape(-1, 8).T.view(np.int32).copy()


def point_words(points) -> np.ndarray:
    """[host.G1] (affine) -> (2, 8, n) int32 words of x and y."""
    return np.stack([int_words([p.x for p in points]),
                     int_words([p.y for p in points])])


def words_to_mont(w: torch.Tensor) -> torch.Tensor:
    """(8, *b) int32 canonical words -> (K, *b) f32 Montgomery limbs of
    the port's limb layer (R = 2^270)."""
    lm = limbs.words_to_limbs(p256_cuda.from_u32_bits(w)).to(torch.float32)
    return limbs.to_mont(lm, SPEC)


def mont_to_words(x: torch.Tensor) -> torch.Tensor:
    """(K, *b) f32 Montgomery limbs (R = 2^270) -> (8, *b) int32
    canonical words."""
    canon = limbs.canonical(limbs.from_mont(x, SPEC), SPEC)
    return p256_cuda.to_u32_bits(limbs.limbs_to_words(canon))


def f12_from_words(w: torch.Tensor) -> torch.Tensor:
    """(12, 8, *b) canonical Fp12 words -> the port's (K, 2, 3, 2, *b)
    Montgomery limb layout (axis 1 the Fp2 component j, 2 the Fp6
    coefficient i, 3 the half h)."""
    rest = tuple(w.shape[2:])
    m = words_to_mont(w.movedim(1, 0))                    # (K, 12, *b)
    return m.reshape((limbs.K, 2, 3, 2) + rest).permute(
        0, 3, 2, 1, *range(4, 4 + len(rest)))


def f12_to_words(f: torch.Tensor) -> torch.Tensor:
    """The port's (K, 2, 3, 2, *b) Fp12 limbs -> (12, 8, *b) canonical
    words."""
    rest = tuple(f.shape[4:])
    c = f.permute(0, 3, 2, 1, *range(4, 4 + len(rest))).reshape(
        (limbs.K, F12_COEFFS) + rest)
    return mont_to_words(c).movedim(0, 1).contiguous()


# --- plain versions ------------------------------------------------------------

def miller_plain(pts: torch.Tensor, lines: torch.Tensor,
                 is_add: torch.Tensor) -> torch.Tensor:
    """The Miller kernel's plain version: ops/fp256bn_dev.py `_miller`
    on the words, every schedule's loops stacked."""
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    xy = words_to_mont(pts.movedim(2, 0))                 # (K, S, 2, n)
    # (S, L, 4, 8) -> (K, 2, L, S, 1): A and B as Fp2, steps, schedules
    lm = words_to_mont(lines.permute(3, 2, 1, 0)).unsqueeze(-1)
    A, B = lm[:, 0:2], lm[:, 2:4]
    f = dev._miller(xy[:, :, 0], xy[:, :, 1], A, B,
                    is_add.cpu().numpy().astype(bool))
    # f: (K, 2, 3, 2, S, n) -> (S, 12, 8, n)
    return f12_to_words(f).movedim(2, 0).contiguous()


def final_exp_plain(f: torch.Tensor, check: bool) -> torch.Tensor:
    """The final exponentiation kernel's plain version: in check mode the
    (n,) bool verdicts of f12_is_one(final_exp_batch(f_0 * f_1)); in
    pairing mode the (12, 8, n) words of final_exp_batch(f_0)."""
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    g = f12_from_words(f[0])
    if check:
        g = dev.f12_mul(g, f12_from_words(f[1]))
        return dev.f12_is_one(dev.final_exp_batch(g))
    return f12_to_words(dev.final_exp_batch(g))


# --- the launches ---------------------------------------------------------------

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def miller(pts: torch.Tensor, lines: torch.Tensor,
           is_add: torch.Tensor) -> torch.Tensor:
    """The Miller loops of S schedules over n lanes: (S, 12, 8, n) int32
    canonical words of each loop's value (conjugated, both correction
    lines applied).  pts (S, 2, 8, n), lines (S, n_main + 2, 4, 8),
    is_add (n_main,) int32.  The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    dev = pts.device
    if dev.type == "cpu":
        return miller_plain(pts, lines, is_add)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from fabric_mod_tpu_torch.ops import _build
    S, n, n_main = pts.shape[0], pts.shape[-1], is_add.shape[0]
    _check(pts, "pts", torch.int32, (S, 2, 8, n), dev)
    _check(lines, "lines", torch.int32, (S, n_main + 2, LINE_VALUES, 8), dev)
    _check(is_add, "is_add", torch.int32, (n_main,), dev)
    out = torch.empty((S, F12_COEFFS, 8, n), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.load("fp256bn_pairing")
    with torch.cuda.device(dev):
        rc = lib.fp256bn_miller_launch(
            pts.data_ptr(), lines.data_ptr(), is_add.data_ptr(), n_main,
            out.data_ptr(), n, S, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fp256bn_miller launch failed: cudaError {rc}")
    LAUNCHES["fp256bn_miller"] += 1
    return out


def final_exp(f: torch.Tensor, check: bool) -> torch.Tensor:
    """Check mode: f (2, 12, 8, n) Miller words -> (n,) bool verdicts
    (f_0 * f_1)^((p^12 - 1)/r) == 1.  Pairing mode: f (1, 12, 8, n) ->
    (12, 8, n) int32 canonical words of f_0^((p^12 - 1)/r).  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    dev = f.device
    if dev.type == "cpu":
        return final_exp_plain(f, check)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from fabric_mod_tpu_torch.ops import _build
    n = f.shape[-1]
    _check(f, "f", torch.int32, (2 if check else 1, F12_COEFFS, 8, n), dev)
    ok = torch.empty(n if check else 0, dtype=torch.bool, device=dev)
    out = torch.empty((F12_COEFFS, 8, 0 if check else n), dtype=torch.int32,
                      device=dev)
    if n == 0:
        return ok if check else out
    lib = _build.load("fp256bn_pairing")
    with torch.cuda.device(dev):
        rc = lib.fp256bn_final_exp_launch(
            f.data_ptr(), int(check), ok.data_ptr(), out.data_ptr(), n,
            _stream(dev))
    if rc != 0:
        raise RuntimeError(f"fp256bn_final_exp launch failed: cudaError {rc}")
    LAUNCHES["fp256bn_final_exp"] += 1
    return ok if check else out


def geometry(n_main: int, dev=None) -> dict:
    """The kernels' launch geometry on the card: threads a lane (G),
    lanes a block, and for each kernel its shared memory a block (the
    Miller kernel's at n_main main steps) and the blocks an SM holds."""
    from fabric_mod_tpu_torch.ops import _build
    lib = _build.load("fp256bn_pairing")
    v = [ctypes.c_int() for _ in range(6)]
    with torch.cuda.device(dev or torch.device("cuda")):
        rc = lib.fp256bn_pairing_geometry(n_main, *(ctypes.byref(x) for x in v))
    if rc != 0:
        raise RuntimeError(f"fp256bn_pairing_geometry failed: cudaError {rc}")
    group, lanes, m_smem, m_blocks, e_smem, e_blocks = (x.value for x in v)
    return {"group": group, "lanes_per_block": lanes,
            "fp256bn_miller": {"smem": m_smem, "blocks_per_sm": m_blocks},
            "fp256bn_final_exp": {"smem": e_smem, "blocks_per_sm": e_blocks}}


# --- the work a lane needs, the bound's count ------------------------------------

# Fp products of the reference's tower operations (the generic square, the
# Fermat inverse)
F2_MUL, F6_MUL, F12_MUL, F12_SQR, F12_MUL_LINE, F12_FROBENIUS = 3, 18, 54, 36, 42, 15
# the Fermat inverse: 256 squares, one product a set bit of p - 2
FP_INV = 256 + bin(host.P - 2).count("1")
# a0^2 and a1^2 (2 Fp6 products); f6_inv: 3 Fp2 squares (2 each), 3 + 3
# Fp2 products, f2_inv (2 squares, the inverse, 2 products), 3 Fp2
# products; a0*t and a1*t
F12_INV = (2 * F6_MUL + 3 * 2 + 6 * F2_MUL + (2 + FP_INV + 2)
           + 3 * F2_MUL + 2 * F6_MUL)
POW_ABS_U = (abs(host.U).bit_length() * F12_SQR
             + bin(abs(host.U)).count("1") * F12_MUL)
# the easy part, three powers, the tail (8 Frobenius maps, 13 products,
# 4 squares)
FINAL_EXP = (F12_INV + 2 * F12_MUL + 2 * F12_FROBENIUS + 3 * POW_ABS_U
             + 8 * F12_FROBENIUS + 13 * F12_MUL + 4 * F12_SQR)
# 32-bit multiply-adds of one Fp product over 8 words: the low and high
# halves of the 64 word products of a*b and of m*p, one multiply a
# quotient digit
MULTIPLY_ADDS = 2 * 64 + 8 + 2 * 64
# a square's: the 36 word products of a*a (28 cross products, doubled,
# and 8 on the diagonal), then the quotient digits and m*p as a product's
SQUARE_MULTIPLY_ADDS = 2 * 36 + 8 + 2 * 64


def products_per_lane(is_add, kernel: str, check: bool = True) -> int:
    """Fp products one lane of `kernel` needs in the reference's formulas
    (the Miller kernel: one schedule of len(is_add) main steps; the final
    exponentiation in check or pairing mode), conversions in and out of
    the Montgomery domain included."""
    if kernel == "fp256bn_miller":
        n_add = int(np.sum(is_add))
        n_dbl = len(is_add) - n_add
        step = 2 + F12_MUL_LINE
        return 2 + n_dbl * (F12_SQR + step) + (n_add + 2) * step + F12_COEFFS
    if kernel == "fp256bn_final_exp":
        if check:
            return 2 * F12_COEFFS + F12_MUL + FINAL_EXP
        return F12_COEFFS + FINAL_EXP + F12_COEFFS
    raise ValueError(f"unknown kernel {kernel}")


def multiply_adds_per_lane(is_add, kernel: str, check: bool = True) -> dict:
    """32-bit multiply-adds one lane of `kernel` needs (the Miller
    kernel: a (lane, schedule)): in the reference's formulas (every one
    of products_per_lane a generic product), in the kernels' own
    (fp256bn_programs.design_counts, a square at its own count; the
    divsteps of the inverse are not counted, only the product that ends
    it), and the least of the two, which the bound counts."""
    reference = products_per_lane(is_add, kernel, check) * MULTIPLY_ADDS
    own = fp256bn_programs.design_counts(is_add, kernel, check)
    design = ((own["products"] - own["squares"]) * MULTIPLY_ADDS
              + own["squares"] * SQUARE_MULTIPLY_ADDS)
    return {"reference": reference, "design": design,
            "least": min(reference, design)}
