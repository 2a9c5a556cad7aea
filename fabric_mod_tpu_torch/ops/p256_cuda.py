"""The Shamir ladder on the card: wrappers of the hand-written CUDA kernels.

Replaces fabric_mod_tpu/ops/p256_pallas.py (`pallas_ladder` ->
`_ladder_kernel`, `pallas_ladder_mixed` -> `_ladder_kernel_mixed`).  The
kernels are csrc/p256_ladder.cu, built by ops/_build.py and bound with
ctypes.

`ladder_words(u1_w, u2_w, qx_w, qy_w, mixed)` is the verify core's
path (ops/p256.py): int32 window planes and the key's words in, the
canonical non-Montgomery X, Y, Z words out — `kernel_words`, the
launch, for CUDA tensors; for CPU tensors the plain ladder
(ops/p256.shamir_ladder / _mixed) between word/limb conversions.
`ladder(u1_w, u2_w, qx_m, qy_m, mixed=...)` keeps the plain ladder's
contract on (K, batch) f32 Montgomery limbs (R = 2^270), for the tests
and chip_smoke's comparison: on a CUDA tensor the plain limb ops convert
in and out around the launch.  No path falls back: a CUDA tensor
launches the kernel or raises.

Each kernel has a launch count (`LAUNCHES`), raised by one where the
wrapper launches it and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fabric_mod_tpu_torch.ops import limbs9 as limbs
from fabric_mod_tpu_torch.ops import p256

KERNELS = {False: "ladder_projective", True: "ladder_mixed"}
LAUNCHES = {name: 0 for name in KERNELS.values()}

_R256 = 1 << 256
_MASK32 = 0xFFFFFFFF


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict:
    return dict(LAUNCHES)


# --- words <-> the int32 containers the kernel reads as uint32 -------------

def to_u32_bits(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bit
    pattern (the kernel reads it as uint32)."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def from_u32_bits(w: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 words in [0, 2^32)."""
    return w.to(torch.int64) & _MASK32


def _int_words(v: int) -> list:
    return [(v >> (32 * k)) & _MASK32 for k in range(8)]


@functools.lru_cache(maxsize=None)
def g_table_words(mixed: bool) -> np.ndarray:
    """The G table in the kernel's form: Montgomery (R = 2^256) words,
    int32 bit patterns.  Projective: (16, 3, 8) [inf, G, ..., 15G];
    mixed: (15, 2, 8) affine [G, ..., 15G]."""
    P = p256.P
    one = _R256 % P
    rows = []
    if not mixed:
        rows.append([_int_words(0), _int_words(one), _int_words(0)])
    for x, y in p256.g_multiples():
        row = [_int_words(x * _R256 % P), _int_words(y * _R256 % P)]
        if not mixed:
            row.append(_int_words(one))
        rows.append(row)
    arr = np.array(rows, np.int64)
    return np.where(arr >= (1 << 31), arr - (1 << 32), arr).astype(np.int32)


# --- the launch -------------------------------------------------------------

def geometry() -> tuple:
    """(threads per lane, threads per block) of the built kernels."""
    from fabric_mod_tpu_torch.ops import _build
    per_lane, block = ctypes.c_int(), ctypes.c_int()
    _build.load("p256_ladder").p256_ladder_geometry(
        ctypes.byref(per_lane), ctypes.byref(block))
    return per_lane.value, block.value


def check_plane(t: torch.Tensor, name: str, dtype, rows: int, n: int, dev):
    """Raise unless `t` is a contiguous (rows, n) `dtype` tensor on `dev`."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != (rows, n) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} ({rows}, {n}) on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def kernel_words(u1_w: torch.Tensor, u2_w: torch.Tensor,
                 qx_w: torch.Tensor, qy_w: torch.Tensor, mixed: bool):
    """Launch one ladder kernel on the current stream.

    u1_w, u2_w: (64, n) int32 windows, MSB window first.  qx_w, qy_w:
    (8, n) int32 bit patterns of the canonical affine key's words.
    Returns X, Y, Z: (8, n) int32 bit patterns of the canonical,
    non-Montgomery projective result."""
    from fabric_mod_tpu_torch.ops import _build
    dev = qx_w.device
    if dev.type != "cuda":
        raise ValueError("kernel_words needs CUDA tensors")
    n = qx_w.shape[1]
    check_plane(u1_w, "u1_w", torch.int32, p256.N_WINDOWS, n, dev)
    check_plane(u2_w, "u2_w", torch.int32, p256.N_WINDOWS, n, dev)
    check_plane(qx_w, "qx_w", torch.int32, 8, n, dev)
    check_plane(qy_w, "qy_w", torch.int32, 8, n, dev)
    lib = _build.load("p256_ladder")
    gtab = limbs.const(g_table_words(bool(mixed)), dev)
    X = torch.empty((8, n), dtype=torch.int32, device=dev)
    Y = torch.empty_like(X)
    Z = torch.empty_like(X)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.p256_ladder_launch(
            int(bool(mixed)), u1_w.data_ptr(), u2_w.data_ptr(),
            qx_w.data_ptr(), qy_w.data_ptr(), gtab.data_ptr(),
            X.data_ptr(), Y.data_ptr(), Z.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"{KERNELS[bool(mixed)]} launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[KERNELS[bool(mixed)]] += 1
    return X, Y, Z


def mont_limbs_to_words(a_m: torch.Tensor) -> torch.Tensor:
    """(K, n) f32 Montgomery limbs (R = 2^270) -> (8, n) int32 bit
    patterns of the canonical, non-Montgomery value's words."""
    fp = p256._consts()[0]
    canon = limbs.canonical(limbs.from_mont(a_m, fp), fp)
    return to_u32_bits(limbs.limbs_to_words(canon))


def words_to_mont_limbs(w: torch.Tensor) -> torch.Tensor:
    """(8, n) int32 bit patterns of canonical words -> (K, n) f32
    Montgomery limbs (R = 2^270)."""
    fp = p256._consts()[0]
    lm = limbs.words_to_limbs(from_u32_bits(w)).to(torch.float32)
    return limbs.to_mont(lm, fp)


def ladder_words(u1_w: torch.Tensor, u2_w: torch.Tensor, qx_w: torch.Tensor,
                 qy_w: torch.Tensor, mixed: bool = False):
    """`kernel_words`' contract (windows, the key's words in; canonical
    non-Montgomery X, Y, Z words out) on any device: the kernel for CUDA
    tensors, the plain ladder for CPU tensors (words converted to
    Montgomery limbs and back).  The verify core's path."""
    if qx_w.device.type == "cuda":
        return kernel_words(u1_w, u2_w, qx_w, qy_w, mixed)
    if qx_w.device.type != "cpu":
        raise ValueError(f"unsupported device {qx_w.device}")
    plain = p256.shamir_ladder_mixed if mixed else p256.shamir_ladder
    out = plain(u1_w, u2_w, words_to_mont_limbs(qx_w),
                words_to_mont_limbs(qy_w))
    return tuple(mont_limbs_to_words(c) for c in out)


def ladder(u1_w: torch.Tensor, u2_w: torch.Tensor, qx_m: torch.Tensor,
           qy_m: torch.Tensor, mixed: bool = False):
    """u1*G + u2*Q with `shamir_ladder`'s contract; the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if qx_m.device.type == "cpu":
        plain = p256.shamir_ladder_mixed if mixed else p256.shamir_ladder
        return plain(u1_w, u2_w, qx_m, qy_m)
    if qx_m.device.type != "cuda":
        raise ValueError(f"unsupported device {qx_m.device}")
    X, Y, Z = kernel_words(
        u1_w.to(torch.int32).contiguous(), u2_w.to(torch.int32).contiguous(),
        mont_limbs_to_words(qx_m).contiguous(),
        mont_limbs_to_words(qy_m).contiguous(), mixed)
    return tuple(words_to_mont_limbs(c) for c in (X, Y, Z))
