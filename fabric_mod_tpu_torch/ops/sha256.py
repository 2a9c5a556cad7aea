"""Batched SHA-256: the raw-message lanes' digest in front of the verify
core.

The port of fabric_mod_tpu/ops/sha256.py (`sha256_blocks`, :81, a
jitted lax.scan).  On the card `sha256_e` launches the hand-written
CUDA kernel of csrc/sha256.cu, which writes each digest straight into
the e rows of the verify core's packed buffer (ops/p256_core.py) for
the lanes whose FLAG_HAS_MSG is set.

What bounds that kernel is the chain, not operations: a lane's blocks
are one chain of 64 dependent rounds each, so a call lasts as long as
its longest lane, and the warp that runs a lane's rounds is the limit
(a full warp's dependent ALU instruction takes ~5.8 cycles on an H100,
and its integer ALU takes a warp instruction in two).  A thread block
is therefore split by role: a producer warp loads each lane's blocks,
expands the message schedule and writes the 64 K_t + W_t of each block
into a ring in shared memory; the consumer warp runs only the rounds,
two threads a lane (one the e-side of each round, the other the a-side
two rounds behind, one shuffle a round), so that each thread dispatches 8
ALU instructions a round on a 3-instruction chain.  The geometry is
fixed (16 lanes a block, one producer warp) from a sweep measured on an
H100, in which lane counts and producer warps moved nothing and the
consumer set the time (PERF.md §6).

For a CPU tensor `sha256_e` is the plain version, `sha256_e_plain`:
`sha256_blocks` in torch ops (the batch axis carries the parallelism;
mixed lengths are padded to the batch's max block count and a lane's
state freezes once its own blocks run out; words in int64 masked to 32
bits, since torch's uint32 op coverage is partial), then
`p256.digest_words_le` and a select.  The kernel has a launch count
(`LAUNCHES`), raised by one where the wrapper launches it and nowhere
else.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF

_H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], np.int64)

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2]


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit rotate right of int64 words in [0, 2^32)."""
    return ((x >> n) | (x << (32 - n))) & M32


def _compress(state, block):
    """One compression: state = 8 (batch,) words, block (batch, 16)."""
    w = [block[:, i] for i in range(16)]
    for t in range(16, 64):
        x1, x14 = w[t - 15], w[t - 2]
        s0 = _rotr(x1, 7) ^ _rotr(x1, 18) ^ (x1 >> 3)
        s1 = _rotr(x14, 17) ^ _rotr(x14, 19) ^ (x14 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f = g, f, e
        e = (d + t1) & M32
        d, c, b = c, b, a
        a = (t1 + s0 + maj) & M32
    return [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_blocks(words: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """Hash pre-padded messages.

    words: (batch, max_blocks, 16) big-endian message words (any int
    dtype holding values < 2^32), padded per FIPS 180-4 within each
    message's own block count.  nblocks: (batch,) real block counts.
    Returns (batch, 8) int64 digest words."""
    words = words.to(torch.int64)
    batch = words.shape[0]
    h0 = torch.as_tensor(_H0, device=words.device)
    state = [h0[i].expand(batch).clone() for i in range(8)]
    for i in range(words.shape[1]):
        new = _compress(state, words[:, i])
        live = i < nblocks
        state = [torch.where(live, n, s) for n, s in zip(new, state)]
    return torch.stack(state, dim=-1)


def digest_to_bytes(digest_words) -> np.ndarray:
    """(..., 8) words -> (..., 32) uint8 big-endian."""
    d = np.asarray(digest_words.cpu() if isinstance(digest_words, torch.Tensor)
                   else digest_words).astype(np.int64)
    out = np.empty(d.shape[:-1] + (32,), np.uint8)
    for i in range(4):
        out[..., i::4] = ((d >> (24 - 8 * i)) & 0xFF).astype(np.uint8)
    return out


# --- the verify core's e rows ------------------------------------------------

KERNELS = ("sha256_e",)
LAUNCHES = {name: 0 for name in KERNELS}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def counts() -> dict:
    return dict(LAUNCHES)


def sha256_e_plain(words: torch.Tensor, nblocks: torch.Tensor,
                   packed: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: `sha256_blocks` of every lane, its
    digest as the verify core's e words (p256.digest_words_le), written
    in place into `packed`'s e rows where the lane's FLAG_HAS_MSG is
    set.  words: (batch, max_blocks, 16) int32 bit patterns of the
    big-endian message words; nblocks: (batch,) int32.  Returns
    `packed`."""
    from fabric_mod_tpu_torch.ops import p256, p256_core
    dw = sha256_blocks(words.to(torch.int64) & M32, nblocks.to(torch.int64))
    e = p256_core.rows(packed, p256_core.ROW_E)
    e.copy_(torch.where(p256_core.has_msg(packed)[None],
                        p256.digest_words_le(dw), e))
    return packed


def sha256_e(words: torch.Tensor, nblocks: torch.Tensor,
             packed: torch.Tensor) -> torch.Tensor:
    """Hash the raw-message lanes into `packed`'s e rows, in place
    (lanes without FLAG_HAS_MSG keep theirs); returns `packed`.

    words: (batch, max_blocks, 16) int32 bit patterns of the uint32
    big-endian words bccsp/der.pack_messages gives; nblocks: (batch,)
    int32 real block counts; packed: the (ROWS, batch) int32 buffer of
    ops/p256_core.pack.  The CUDA kernel for CUDA tensors (raising on
    any fault), the plain version for CPU tensors."""
    from fabric_mod_tpu_torch.ops import p256_core, p256_cuda
    dev = packed.device
    if dev.type == "cpu":
        return sha256_e_plain(words, nblocks, packed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    from fabric_mod_tpu_torch.ops import _build
    n = packed.shape[1]
    p256_cuda.check_plane(packed, "packed", torch.int32, p256_core.ROWS, n,
                          dev)
    if words.device != dev or words.dtype != torch.int32 \
            or words.dim() != 3 or words.shape[0] != n \
            or words.shape[2] != 16 or not words.is_contiguous() \
            or words.data_ptr() % 16:
        raise ValueError(f"words: expected contiguous, 16-byte aligned "
                         f"int32 ({n}, max_blocks, 16) on {dev}, got "
                         f"{words.dtype} {tuple(words.shape)} on "
                         f"{words.device}")
    if nblocks.device != dev or nblocks.dtype != torch.int32 \
            or tuple(nblocks.shape) != (n,) or not nblocks.is_contiguous():
        raise ValueError(f"nblocks: expected contiguous int32 ({n},) on "
                         f"{dev}")
    lib = _build.load("sha256")
    with torch.cuda.device(dev):
        rc = lib.sha256_e_launch(
            words.data_ptr(), nblocks.data_ptr(), words.shape[1],
            packed.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sha256_e launch failed: cudaError {rc}")
    LAUNCHES["sha256_e"] += 1
    return packed
