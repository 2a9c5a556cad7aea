"""The verify core's prologue and epilogue on the card: wrappers of the
hand-written CUDA kernels of csrc/p256_core.cu.

Replaces the prologue and epilogue of fabric_mod_tpu/ops/p256.py
`_verify_core_impl` (:516), which the JAX package runs inside one jitted
device program with the ladder (`verify_core` :570, `verify_core_fused`
:601).  Their plain versions are ops/p256.py `verify_prologue_plain` and
`verify_epilogue_plain`.

The inputs travel as ONE packed int32 buffer of (ROWS, batch): the
digest e, r, s, qx, qy as 8 little-endian 32-bit words each (int32 bit
patterns, as the ladder's words), then a row of flags (range_ok,
pre_ok, rn_lt_p, has_msg).  `pack` builds it on the host from the byte
planes with numpy; the caller uploads it in one copy.

`prologue(e, packed)` -> (u1_w, u2_w, key_ok) and
`epilogue(X, Z, packed, key_ok)` -> ok launch the kernels for CUDA
tensors and raise on any fault; for CPU tensors they ARE the plain
versions (words to limbs, the plain limb code, back).  Each kernel has a
launch count (`LAUNCHES`), raised by one where the wrapper launches it
and nowhere else.
"""
from __future__ import annotations

import numpy as np
import torch

from fabric_mod_tpu_torch.ops import limbs9 as limbs
from fabric_mod_tpu_torch.ops import p256, p256_cuda

# the packed buffer's layout (csrc/p256_core.cu kRow*, kFlag*)
ROW_E, ROW_R, ROW_S, ROW_QX, ROW_QY = 0, 8, 16, 24, 32
ROW_FLAGS = 40
ROWS = 41
FLAG_RANGE_OK, FLAG_PRE_OK, FLAG_RN_LT_P, FLAG_HAS_MSG = 1, 2, 4, 8

KERNELS = ("verify_prologue", "verify_epilogue")
LAUNCHES = {name: 0 for name in KERNELS}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict:
    return dict(LAUNCHES)


# --- the packed buffer -------------------------------------------------------

def be_words(plane: np.ndarray) -> np.ndarray:
    """(batch, 32) uint8 big-endian -> (8, batch) int32 bit patterns of
    the little-endian 32-bit words (least significant word first)."""
    le = np.ascontiguousarray(np.asarray(plane, np.uint8)[:, ::-1])
    return le.view("<u4").T.view(np.int32)


def pack(planes, range_ok, pre_ok, rn_lt_p, has_msg=None) -> np.ndarray:
    """The (ROWS, batch) int32 buffer from the five (batch, 32) byte
    planes (e, r, s, qx, qy) and the (batch,) bool flags."""
    n = len(range_ok)
    out = np.empty((ROWS, n), np.int32)
    for row, plane in zip((ROW_E, ROW_R, ROW_S, ROW_QX, ROW_QY), planes):
        out[row:row + 8] = be_words(plane)
    flags = (np.asarray(range_ok, bool) * FLAG_RANGE_OK
             | np.asarray(pre_ok, bool) * FLAG_PRE_OK
             | np.asarray(rn_lt_p, bool) * FLAG_RN_LT_P)
    if has_msg is not None:
        flags = flags | np.asarray(has_msg, bool) * FLAG_HAS_MSG
    out[ROW_FLAGS] = flags
    return out


def rows(packed: torch.Tensor, row: int) -> torch.Tensor:
    """The 8 word rows of one value, a contiguous (8, batch) view."""
    return packed[row:row + 8]


def flag(packed: torch.Tensor, bit: int) -> torch.Tensor:
    return (packed[ROW_FLAGS] & bit) != 0


def has_msg(packed: torch.Tensor) -> torch.Tensor:
    return flag(packed, FLAG_HAS_MSG)


def _limbs(words: torch.Tensor) -> torch.Tensor:
    """(8, batch) int32 bit patterns -> (K, batch) f32 canonical limbs."""
    return limbs.words_to_limbs(p256_cuda.from_u32_bits(words)).to(
        torch.float32)


# --- the inversion's schedule ------------------------------------------------

DIVSTEP_BATCH = 30


def divsteps(x: int) -> int:
    """Divsteps the prologue kernel's inversion of x mod n takes until
    g = 0 (Bernstein-Yang with delta = 1 at the start, f = n, g = x);
    the kernel runs them in batches of DIVSTEP_BATCH and stops after the
    first batch that leaves g = 0 (0 divsteps for x = 0: one batch)."""
    delta, f, g, count = 1, p256.N, x % p256.N, 0
    while g:
        if delta > 0 and g & 1:
            delta, f, g = 1 - delta, g, (g - f) >> 1
        else:
            delta, g = 1 + delta, (g + (g & 1) * f) >> 1
        count += 1
    return count


def inversion_batches(s: int) -> int:
    """Batches of 30 divsteps the prologue runs for a lane's scalar s (it
    inverts s * 2^256 mod n, s in Montgomery form)."""
    return max(1, -(-divsteps((s << 256) % p256.N) // DIVSTEP_BATCH))


# --- plain versions ----------------------------------------------------------

def prologue_plain(e: torch.Tensor, packed: torch.Tensor):
    """The prologue kernel's plain version (ops/p256.verify_prologue_plain
    on the buffer's words): (u1_w, u2_w, key_ok)."""
    u1_w, u2_w, _qx_m, _qy_m, key_ok = p256.verify_prologue_plain(
        _limbs(e), *(_limbs(rows(packed, r))
                     for r in (ROW_R, ROW_S, ROW_QX, ROW_QY)))
    return u1_w, u2_w, key_ok


def epilogue_plain(X: torch.Tensor, Z: torch.Tensor, packed: torch.Tensor,
                   key_ok: torch.Tensor) -> torch.Tensor:
    """The epilogue kernel's plain version (ops/p256.verify_epilogue_plain
    on the ladder's words, masked by range_ok and pre_ok)."""
    ok = p256.verify_epilogue_plain(
        p256_cuda.words_to_mont_limbs(X), p256_cuda.words_to_mont_limbs(Z),
        _limbs(rows(packed, ROW_R)), flag(packed, FLAG_RN_LT_P), key_ok)
    return ok & flag(packed, FLAG_RANGE_OK) & flag(packed, FLAG_PRE_OK)


# --- the launches ------------------------------------------------------------

def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def prologue(e: torch.Tensor, packed: torch.Tensor):
    """w = s^-1, u1 = e*w, u2 = r*w mod n as (64, batch) int32 window
    planes (most significant window first), and the (batch,) bool
    key_ok.  e: (8, batch) digest words (rows(packed, ROW_E), or the
    card's SHA-256 on the raw path).  The CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    dev = packed.device
    if dev.type == "cpu":
        return prologue_plain(e, packed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from fabric_mod_tpu_torch.ops import _build
    n = packed.shape[1]
    p256_cuda.check_plane(packed, "packed", torch.int32, ROWS, n, dev)
    p256_cuda.check_plane(e, "e", torch.int32, 8, n, dev)
    lib = _build.load("p256_core")
    u1_w = torch.empty((p256.N_WINDOWS, n), dtype=torch.int32, device=dev)
    u2_w = torch.empty_like(u1_w)
    key_ok = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.p256_core_prologue_launch(
            e.data_ptr(), packed.data_ptr(), u1_w.data_ptr(),
            u2_w.data_ptr(), key_ok.data_ptr(), n, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"verify_prologue launch failed: cudaError {rc}")
    LAUNCHES["verify_prologue"] += 1
    return u1_w, u2_w, key_ok


def epilogue(X: torch.Tensor, Z: torch.Tensor, packed: torch.Tensor,
             key_ok: torch.Tensor) -> torch.Tensor:
    """The (batch,) bool verdicts from the ladder's canonical X, Z words
    (8, batch): range_ok & pre_ok & key_ok & Z != 0 & X == r'*Z (mod
    p), r' in {r, r + n where rn_lt_p}.  The CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    dev = packed.device
    if dev.type == "cpu":
        return epilogue_plain(X, Z, packed, key_ok)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from fabric_mod_tpu_torch.ops import _build
    n = packed.shape[1]
    p256_cuda.check_plane(packed, "packed", torch.int32, ROWS, n, dev)
    p256_cuda.check_plane(X, "X", torch.int32, 8, n, dev)
    p256_cuda.check_plane(Z, "Z", torch.int32, 8, n, dev)
    if key_ok.device != dev or key_ok.dtype != torch.bool \
            or tuple(key_ok.shape) != (n,) or not key_ok.is_contiguous():
        raise ValueError(f"key_ok: expected contiguous bool ({n},) on {dev}")
    lib = _build.load("p256_core")
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = lib.p256_core_epilogue_launch(
            X.data_ptr(), Z.data_ptr(), packed.data_ptr(), key_ok.data_ptr(),
            ok.data_ptr(), n, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"verify_epilogue launch failed: cudaError {rc}")
    LAUNCHES["verify_epilogue"] += 1
    return ok

