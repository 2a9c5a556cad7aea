"""Vectorized DER signature decoding + batch byte marshalling.

The port's own copy of fabric_mod_tpu/bccsp/der.py (numpy only, kept
verbatim so the two marshal paths cannot drift; tests/test_torch_marshal.py
holds them equal).

The verify front-end used to decode every signature with a per-item
python DER parse (`decode_dss_signature`) and marshal digests/keys
one `np.frombuffer` at a time — at 2048 items per bucket that python
loop serialized the host against the device (BENCH_r05: the device sat
idle while the front-end marshalled).  This module replaces the loop
with whole-batch numpy:

* `pack_fixed`  — one `b"".join` + one `np.frombuffer` for all the
  fixed-width fields (digests, public keys), with a per-row length
  mask instead of per-item try/except.
* `decode_der_batch` — the ECDSA-Sig-Value DER grammar evaluated as
  array arithmetic over an (n, MAX_SIG) byte matrix: tag/length
  checks are boolean columns, the dynamic s-offset is a
  `take_along_axis` gather, and the r/s big-endian values land
  right-aligned in (n, 32) planes via one masked gather each.

Strictness matches the `cryptography` parser the per-item path used
(and the reference's low-S pipeline expects): short-form lengths only
(a valid P-256 ECDSA-Sig-Value body is <= 70 bytes, so a long-form
length is by definition non-minimal DER), minimal positive INTEGER
encodings, and exact trailing-length accounting.  Anything else marks
the row invalid — never an exception, batch-poisoning is not
acceptable on the commit path (bccsp/api.py verify_batch contract).

Pure numpy on purpose: the bench marshalling microbench and any
host-only caller can use it without touching torch.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# A valid P-256 ECDSA-Sig-Value is at most 2 + 2·(2 + 33) = 72 bytes;
# anything longer is invalid and only needs to be length-checked, so
# the staging matrix can stay fixed-width.
MAX_SIG = 80


def pack_fixed(vals: Sequence[bytes], width: int,
               rows: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pack same-width byte strings into one (rows, width) uint8 matrix.

    Rows whose input is not exactly `width` bytes come back zeroed with
    ok=False (the old per-item loop's length check, batched).  `rows`
    pads the matrix up to a bucket size; `ok` is always (rows,).
    """
    n = len(vals)
    rows = max(rows, n)
    out = np.zeros((rows, width), np.uint8)
    ok = np.zeros(rows, bool)
    if n == 0:
        return out, ok
    # Fast path: all entries are bytes of the right width — one C-level
    # join, no per-item python.  Anything else (wrong width, None, str)
    # falls to the defensive pass where each bad entry marks ITS row
    # invalid; it must never raise and poison the other rows of a
    # coalesced batch (the old per-item loop's try/except, batched).
    try:
        lens = np.fromiter(map(len, vals), np.int32, n)
        if (lens == width).all():
            packed = np.frombuffer(b"".join(vals),
                                   np.uint8).reshape(n, width)
            if rows == n:
                ok[:] = True
                return packed, ok         # zero-copy (read-only) view
            out[:n] = packed
            ok[:n] = True
            return out, ok
    except TypeError:
        pass
    vals = [v if isinstance(v, (bytes, bytearray)) else b""
            for v in vals]
    ok[:n] = np.fromiter((len(v) == width for v in vals), bool, n)
    buf = b"".join(v if len(v) == width else b"\x00" * width
                   for v in vals)
    out[:n] = np.frombuffer(buf, np.uint8).reshape(n, width)
    return out, ok


def lt_bytes(a: np.ndarray, bound: bytes) -> np.ndarray:
    """Lexicographic a < bound over (..., 32) big-endian byte rows
    (numpy-only twin of ops/p256._lt_bytes, kept here so the marshal
    path has no device dependency).  Words, not bytes: 32 big-endian
    bytes view as 4 big-endian u64 words, and the lexicographic
    compare cascades over 4 word lanes instead of 32 byte lanes."""
    a8 = np.ascontiguousarray(a).view(">u8")         # (..., 4)
    b8 = np.frombuffer(bound, ">u8")                 # (4,)
    lt = a8 < b8
    eq = a8 == b8
    out = lt[..., 3]
    for i in (2, 1, 0):
        out = lt[..., i] | (eq[..., i] & out)
    return out


def pack_messages(msgs: Sequence[bytes], rows: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized FIPS 180-4 SHA-256 padding for a whole batch: the
    message lane of the fused hash->verify marshal (bccsp/gpu.
    marshal_items): one slice copy per message into a zeroed plane,
    the padding bytes and bit lengths set for all rows at once.

    Returns (words, nblocks, ok): (rows, max_blocks, 16) uint32
    big-endian message words padded within each message's own block
    count, the (rows,) int32 real-block counts, and the validity mask
    (non-bytes entries come back as zeroed one-block rows with
    ok=False — never an exception, same contract as pack_fixed).

    max_blocks is the longest message's block count: the kernel loops
    over each lane's own blocks, so the plane is not rounded up (the
    reference rounds it to a power of two to bound its compiled XLA
    shapes).  Identical output to sha256.pad_messages on the unpadded
    prefix (differential-tested).
    """
    n = len(msgs)
    rows = max(rows, n)
    ok = np.zeros(rows, bool)
    # memoryview included: a valid row's verdict may not depend on an
    # unrelated malformed row
    ok[:n] = [isinstance(v, (bytes, bytearray, memoryview)) for v in msgs]
    if not ok[:n].all():
        msgs = [v if ok[i] else b"" for i, v in enumerate(msgs)]
    lens = np.fromiter(map(len, msgs), np.int64, n)
    nb32 = np.zeros(rows, np.int32)
    if n:
        nb = (lens + 8) // 64 + 1
        nb32[:n] = nb
    maxb = int(nb32.max()) if n else 1
    maxb = max(maxb, 1)
    buf = np.zeros((rows, maxb * 64), np.uint8)
    if n:
        # one slice copy a row: a scatter of every byte by fancy index
        # costs ~4x more at a 2048-lane bucket of ~1 KB messages
        for i, msg in enumerate(msgs):
            buf[i, :len(msg)] = np.frombuffer(msg, np.uint8)
        r = np.arange(n)
        buf[r, lens] = 0x80
        # the 64-bit big-endian bit length in each message's last 8 bytes
        tail = (nb * 64 - 8)[:, None] + np.arange(8)
        buf[r[:, None], tail] = (lens * 8).astype(">u8").view(
            np.uint8).reshape(n, 8)
    # the big-endian 32-bit words: a byte-swapping read of the rows
    words = buf.view(">u4").astype(np.uint32).reshape(rows, maxb, 16)
    return words, nb32, ok


def decode_der_batch(sigs: Sequence[bytes], rows: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode ECDSA-Sig-Value DER for a whole batch at once.

    Returns (r, s, ok): (rows, 32) uint8 big-endian scalar planes and
    the (rows,) validity mask.  Invalid rows (bad grammar, non-minimal
    or oversized integers, trailing garbage) are zeroed with ok=False.
    """
    n = len(sigs)
    rows = max(rows, n)
    r_out = np.zeros((rows, 32), np.uint8)
    s_out = np.zeros((rows, 32), np.uint8)
    ok_out = np.zeros(rows, bool)
    if n == 0:
        return r_out, s_out, ok_out

    # non-bytes rows become invalid, never exceptions (see pack_fixed)
    try:
        lens = np.fromiter(map(len, sigs), np.int64, n)
        joined = b"".join(sigs)
    except TypeError:
        sigs = [x if isinstance(x, (bytes, bytearray)) else b""
                for x in sigs]
        lens = np.fromiter(map(len, sigs), np.int64, n)
        joined = b"".join(sigs)

    # The grammar only ever reads ~10 scalar columns and two 32-byte
    # windows per row, so gather those straight from the concatenated
    # byte string — no (n, MAX_SIG) staging matrix.  Gathered bytes
    # can cross into a NEIGHBORING row only at positions the length
    # accounting proves out-of-row; every such read feeds either a
    # check that then fails (ok=False) or a value the check structure
    # ignores (e.g. the second content byte of a 1-byte INTEGER), so
    # verdicts and extracted values never depend on neighbor bytes.
    flat = np.frombuffer(joined, np.uint8)
    if flat.size == 0 or flat.size > (1 << 31) - 64:
        return r_out, s_out, ok_out   # all-empty (or absurd) batch
    starts = np.zeros(n, np.int32)
    np.cumsum(lens[:-1], out=starts[1:], dtype=np.int32)
    top = np.int32(flat.size - 1)

    def cols(off, k):
        """(n, k) int32 bytes at per-row offsets off..off+k-1, ONE
        bounded fancy gather (np.take(mode="clip") is several times
        slower than minimum+fancy on this path, and per-column calls
        pay numpy dispatch k times over)."""
        idx = off[:, None] + np.arange(k, dtype=np.int32)
        return flat[np.minimum(idx, top)].astype(np.int32)

    # One gather for the fixed-offset header region: SEQUENCE tag+len,
    # r INTEGER tag+len and its first two content bytes.
    hdr = cols(starts, 6)
    seq_len, rlen = hdr[:, 1], hdr[:, 3]

    # SEQUENCE header: short-form length covering exactly the rest.
    ok = (lens >= 8) & (lens <= MAX_SIG)
    ok &= (hdr[:, 0] == 0x30) & (seq_len < 0x80) & (seq_len + 2 == lens)
    # r INTEGER at fixed offset 2.
    ok &= (hdr[:, 2] == 0x02) & (rlen >= 1) & (rlen <= 33)
    rlen_c = np.clip(rlen, 1, 33)

    # s INTEGER at the dynamic offset 4 + rlen: one gather for its
    # tag, length, and first two content bytes.
    s_hdr = 4 + rlen_c
    sh = cols(starts + s_hdr, 4)
    slen = sh[:, 1]
    ok &= (sh[:, 0] == 0x02) & (slen >= 1) & (slen <= 33)
    slen_c = np.clip(slen, 1, 33)
    # exact accounting: SEQUENCE body is the two INTEGER TLVs, nothing
    # after (trailing garbage is invalid DER).
    ok &= seq_len == 4 + rlen + slen

    def int_ok(c0, c1, length):
        """Minimal positive INTEGER content: no high bit on the lead
        byte, a 0x00 pad only when required, 33 bytes only as pad+32."""
        positive = (c0 & 0x80) == 0
        minimal = ~((c0 == 0) & (length > 1) & (c1 < 0x80))
        fits = (length < 33) | (c0 == 0)
        return positive & minimal & fits

    ok &= int_ok(hdr[:, 4], hdr[:, 5], rlen) \
        & int_ok(sh[:, 2], sh[:, 3], slen)

    # Both 32-byte value windows in ONE flat gather + ONE mask: the
    # right-aligned start skips a 33-byte content's 0x00 pad; the mask
    # zero-fills short contents on the left AND zeroes invalid rows
    # (so no half-decoded values leak).  Every unmasked position
    # provably lands inside its own row's content window (see the
    # cross-row note above), so the clip never matters for kept bytes.
    col32 = np.arange(32, dtype=np.int32)
    idx = np.empty((n, 64), np.int32)
    np.add((starts + 4 + rlen_c - 32)[:, None], col32, out=idx[:, :32])
    np.add((starts + s_hdr + 2 + slen_c - 32)[:, None], col32,
           out=idx[:, 32:])
    np.clip(idx, 0, top, out=idx)
    vals = flat[idx]
    valid = np.empty((n, 64), bool)
    np.greater_equal(col32, (32 - np.minimum(rlen_c, 32))[:, None],
                     out=valid[:, :32])
    np.greater_equal(col32, (32 - np.minimum(slen_c, 32))[:, None],
                     out=valid[:, 32:])
    valid &= ok[:, None]
    vals = np.where(valid, vals, 0)
    if rows == n:
        return (np.ascontiguousarray(vals[:, :32]),
                np.ascontiguousarray(vals[:, 32:]), ok)
    r_out[:n] = vals[:, :32]
    s_out[:n] = vals[:, 32:]
    ok_out[:n] = ok
    return r_out, s_out, ok_out


def decode_der_one(sig: bytes) -> Tuple[int, int]:
    """Single-signature convenience over the batch decoder (python
    ints out, ValueError on invalid DER) — keeps one grammar for both
    shapes so they cannot drift."""
    r, s, ok = decode_der_batch([sig])
    if not ok[0]:
        raise ValueError("invalid ECDSA-Sig-Value DER")
    return (int.from_bytes(r[0].tobytes(), "big"),
            int.from_bytes(s[0].tobytes(), "big"))
