"""Durable, log-structured state and history storage.

The port's copy of fabric_mod_tpu/ledger/durable.py: `_LogStore` (:87),
`DurableStateDB` (:128) and `DurableHistoryDB` (:523) (reference
contracts: kvledger/txmgmt/statedb/stateleveldb/stateleveldb.go:379 — a
disk-backed versioned KV with a savepoint — and kvledger/history/db.go,
a persisted key-history index).  The file formats are the reference's
byte for byte, so a store directory written by either package opens in
the other.

Layout per store directory:

  <name>-log-<gen>.dat    CRC32-framed records, appended per block and
                          fsynced once per block; the log ends
                          (logically) at the last complete SAVEPOINT
                          record — a torn tail past it is cropped on
                          open (the block store's crash model)
  <name>-ckpt-<gen>.dat   sha256-sealed index checkpoint: (savepoint,
                          log offset watermark, index entries).  Open
                          = load the checkpoint + replay the log tail
                          after the watermark — O(delta since the
                          checkpoint), never O(chain)

Compaction (state store only) rewrites the live records into gen+1 and
drops the old generation.  Values live on disk; the in-memory keydir
holds only (offset, length, version) pointers, so resident memory is
O(#keys), not O(total value bytes).  The reference's metrics are left
out: `DurableStateDB.batch_writes` and `batch_frames` count its batched
writes and their frames.
"""
from __future__ import annotations

import bisect
import hashlib
import io
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch, Version

_PUT, _DEL, _SAVE, _POST, _META = 0, 1, 2, 3, 4


def _pack_str(out: io.BytesIO, s: bytes) -> None:
    out.write(struct.pack("<I", len(s)))
    out.write(s)


def _frame(payload: bytes) -> bytes:
    return struct.pack("<II", len(payload), zlib.crc32(payload)) + payload


def _iter_records(buf: bytes, start: int):
    """Yield (offset_after, payload) for each intact record; stops at
    the first torn/corrupt frame."""
    pos = start
    n = len(buf)
    while pos + 8 <= n:
        ln, crc = struct.unpack_from("<II", buf, pos)
        end = pos + 8 + ln
        if end > n:
            return
        payload = buf[pos + 8:end]
        if zlib.crc32(payload) != crc:
            return
        yield end, payload
        pos = end


class _LogStore:
    """Shared append-log + checkpoint machinery."""

    def __init__(self, dir_path: str, name: str):
        self.dir = dir_path
        self.name = name
        os.makedirs(dir_path, exist_ok=True)

    def _path(self, kind: str, gen: int) -> str:
        return os.path.join(self.dir, f"{self.name}-{kind}-{gen:08d}.dat")

    def generations(self) -> List[int]:
        out = []
        prefix = f"{self.name}-log-"
        for fn in os.listdir(self.dir):
            if fn.startswith(prefix) and fn.endswith(".dat"):
                out.append(int(fn[len(prefix):-4]))
        return sorted(out)

    def write_checkpoint(self, gen: int, body: bytes) -> None:
        sealed = body + hashlib.sha256(body).digest()
        tmp = self._path("ckpt", gen) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(sealed)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path("ckpt", gen))

    def read_checkpoint(self, gen: int) -> Optional[bytes]:
        path = self._path("ckpt", gen)
        if not os.path.exists(path):
            return None
        raw = open(path, "rb").read()
        if len(raw) < 32:
            return None
        body, digest = raw[:-32], raw[-32:]
        if hashlib.sha256(body).digest() != digest:
            return None
        return body


class DurableStateDB:
    """Disk-backed versioned KV matching statedb.VersionedDB's API."""

    CKPT_EVERY = 64                     # blocks between index checkpoints
    COMPACT_MIN_BYTES = 8 * 1024 * 1024
    COMPACT_DEAD_RATIO = 0.5

    def __init__(self, dir_path: str):
        self._store = _LogStore(dir_path, "state")
        # keydir: (ns, key) -> (offset_of_value, value_len, Version)
        self._keydir: Dict[Tuple[str, str], Tuple[int, int, Version]] = {}
        # key metadata lives in RAM (small: endorsement overrides etc.)
        self._metadata: Dict[Tuple[str, str], Dict[str, bytes]] = {}
        self._keys: Dict[str, List[str]] = {}
        self._savepoint = -1
        self._dead_bytes = 0
        self._blocks_since_ckpt = 0
        # apply_updates calls (each ONE buffered log write and one
        # fsync for the whole block) and the frames they carried
        # (put/del/meta/savepoint): frames per write is the batching
        # ratio
        self.batch_writes = 0
        self.batch_frames = 0
        self._open()

    # -- open / recovery ---------------------------------------------------
    def _open(self) -> None:
        gens = self._store.generations()
        self._gen = gens[-1] if gens else 0
        path = self._store._path("log", self._gen)
        if not os.path.exists(path):
            open(path, "wb").close()
        raw = open(path, "rb").read()

        start = 0
        ckpt = self._store.read_checkpoint(self._gen)
        if ckpt is not None:
            start = self._load_checkpoint(ckpt)
            if start > len(raw):            # log shorter than watermark
                start = 0
                self._keydir.clear()
                self._keys.clear()
                self._metadata.clear()
                self._savepoint = -1

        # replay the tail; remember the offset after the last SAVEPOINT
        committed_end = start
        pending: Dict[Tuple[str, str], Tuple[int, int, Optional[Version]]] = {}
        pending_meta: List[Tuple[str, str, Dict[str, bytes], Version]] = []
        sp = self._savepoint
        for end, payload in _iter_records(raw, start):
            kind = payload[0]
            if kind == _SAVE:
                (blk,) = struct.unpack_from("<q", payload, 1)
                for (ns, key), (off, vlen, ver) in pending.items():
                    self._apply_mem(ns, key, off, vlen, ver)
                pending.clear()
                for ns, key, entries, ver in pending_meta:
                    self._apply_meta_mem(ns, key, entries, ver)
                pending_meta.clear()
                sp = blk
                committed_end = end
            elif kind in (_PUT, _DEL):
                # payload begins at end - len(payload) in the file
                ns, key, off, vlen, ver = self._parse_put_del(
                    payload, end - len(payload))
                pending[(ns, key)] = (off, vlen, ver)
            elif kind == _META:
                pending_meta.append(self._parse_meta(payload))
        self._savepoint = sp
        if committed_end < len(raw):        # crop torn tail
            with open(path, "r+b") as f:
                f.truncate(committed_end)
        self._f = open(path, "a+b")
        self._fr = open(path, "rb")
        self._log_size = committed_end

    def _parse_put_del(self, payload: bytes, frame_payload_off: int):
        kind = payload[0]
        pos = 1
        (nl,) = struct.unpack_from("<I", payload, pos); pos += 4
        ns = payload[pos:pos + nl].decode(); pos += nl
        (kl,) = struct.unpack_from("<I", payload, pos); pos += 4
        key = payload[pos:pos + kl].decode(); pos += kl
        bn, tn = struct.unpack_from("<qq", payload, pos); pos += 16
        if kind == _DEL:
            return ns, key, -1, -1, None
        (vl,) = struct.unpack_from("<I", payload, pos); pos += 4
        # offset of the value within the whole log file
        val_off = frame_payload_off + pos
        return ns, key, val_off, vl, (bn, tn)

    def _parse_meta(self, payload: bytes):
        pos = 1
        (nl,) = struct.unpack_from("<I", payload, pos); pos += 4
        ns = payload[pos:pos + nl].decode(); pos += nl
        (kl,) = struct.unpack_from("<I", payload, pos); pos += 4
        key = payload[pos:pos + kl].decode(); pos += kl
        bn, tn = struct.unpack_from("<qq", payload, pos); pos += 16
        (n,) = struct.unpack_from("<I", payload, pos); pos += 4
        entries = {}
        for _ in range(n):
            (ml,) = struct.unpack_from("<I", payload, pos); pos += 4
            name = payload[pos:pos + ml].decode(); pos += ml
            (vl,) = struct.unpack_from("<I", payload, pos); pos += 4
            entries[name] = payload[pos:pos + vl]; pos += vl
        return ns, key, entries, (bn, tn)

    def _apply_meta_mem(self, ns: str, key: str,
                        entries: Dict[str, bytes], ver: Version) -> None:
        got = self._keydir.get((ns, key))
        if got is None:
            return                          # metadata without key: no-op
        self._keydir[(ns, key)] = (got[0], got[1], ver)  # version bump
        if entries:
            self._metadata[(ns, key)] = dict(entries)
        else:
            self._metadata.pop((ns, key), None)

    def _apply_mem(self, ns: str, key: str, off: int, vlen: int,
                   ver: Optional[Version]) -> None:
        keys = self._keys.setdefault(ns, [])
        exists = (ns, key) in self._keydir
        if ver is None:                     # delete
            if exists:
                self._dead_bytes += self._keydir[(ns, key)][1]
                del self._keydir[(ns, key)]
                self._metadata.pop((ns, key), None)
                keys.pop(bisect.bisect_left(keys, key))
        else:
            if exists:
                self._dead_bytes += self._keydir[(ns, key)][1]
            self._keydir[(ns, key)] = (off, vlen, ver)
            if not exists:
                bisect.insort(keys, key)

    # -- checkpoint format --------------------------------------------------
    def _load_checkpoint(self, body: bytes) -> int:
        pos = 0
        self._savepoint, watermark, count = struct.unpack_from("<qqq", body, pos)
        pos += 24
        for _ in range(count):
            (nl,) = struct.unpack_from("<I", body, pos); pos += 4
            ns = body[pos:pos + nl].decode(); pos += nl
            (kl,) = struct.unpack_from("<I", body, pos); pos += 4
            key = body[pos:pos + kl].decode(); pos += kl
            off, vlen, bn, tn = struct.unpack_from("<qqqq", body, pos)
            pos += 32
            self._keydir[(ns, key)] = (off, vlen, (bn, tn))
            self._keys.setdefault(ns, []).append(key)
        # bulk-sort once: O(n log n), not per-key insort O(n^2)
        for keys in self._keys.values():
            keys.sort()
        if pos < len(body):                 # metadata section (v2)
            (mcount,) = struct.unpack_from("<q", body, pos)
            pos += 8
            for _ in range(mcount):
                (nl,) = struct.unpack_from("<I", body, pos); pos += 4
                ns = body[pos:pos + nl].decode(); pos += nl
                (kl,) = struct.unpack_from("<I", body, pos); pos += 4
                key = body[pos:pos + kl].decode(); pos += kl
                (n,) = struct.unpack_from("<I", body, pos); pos += 4
                entries = {}
                for _ in range(n):
                    (ml,) = struct.unpack_from("<I", body, pos); pos += 4
                    name = body[pos:pos + ml].decode(); pos += ml
                    (vl,) = struct.unpack_from("<I", body, pos); pos += 4
                    entries[name] = body[pos:pos + vl]; pos += vl
                self._metadata[(ns, key)] = entries
        return watermark

    def _write_checkpoint(self) -> None:
        buf = io.BytesIO()
        buf.write(struct.pack("<qqq", self._savepoint, self._log_size,
                              len(self._keydir)))
        for (ns, key), (off, vlen, (bn, tn)) in self._keydir.items():
            _pack_str(buf, ns.encode())
            _pack_str(buf, key.encode())
            buf.write(struct.pack("<qqqq", off, vlen, bn, tn))
        buf.write(struct.pack("<q", len(self._metadata)))
        for (ns, key), entries in self._metadata.items():
            _pack_str(buf, ns.encode())
            _pack_str(buf, key.encode())
            buf.write(struct.pack("<I", len(entries)))
            for name, val in sorted(entries.items()):
                _pack_str(buf, name.encode())
                _pack_str(buf, val)
        self._store.write_checkpoint(self._gen, buf.getvalue())

    # -- reads --------------------------------------------------------------
    def _read_value(self, off: int, vlen: int) -> bytes:
        self._fr.seek(off)
        return self._fr.read(vlen)

    def get_state(self, ns: str, key: str):
        got = self._keydir.get((ns, key))
        if got is None:
            return None
        off, vlen, ver = got
        return self._read_value(off, vlen), ver

    def get_version(self, ns: str, key: str) -> Optional[Version]:
        got = self._keydir.get((ns, key))
        return got[2] if got else None

    def get_versions_many(self, pairs) -> List[Optional[Version]]:
        """Bulk committed-version lookup (vectorized MVCC hash-join):
        pure keydir probes — no value reads, no log I/O — so a block's
        whole version resolution is one call even on the durable arm
        (reference: statedb.BulkOptimizable LoadCommittedVersions)."""
        keydir = self._keydir
        out = []
        for pair in pairs:
            got = keydir.get(pair)
            out.append(got[2] if got else None)
        return out

    def get_metadata(self, ns: str, key: str) -> Optional[Dict[str, bytes]]:
        got = self._metadata.get((ns, key))
        return dict(got) if got else None

    def iter_state(self):
        """Deterministic full scan: (ns, key, value, version) sorted."""
        for (ns, key) in sorted(self._keydir):
            off, vlen, ver = self._keydir[(ns, key)]
            yield ns, key, self._read_value(off, vlen), ver

    def iter_metadata(self):
        """Deterministic full metadata scan: (ns, key, {name: value})
        sorted (same contract as VersionedDB.iter_metadata)."""
        for (ns, key) in sorted(self._metadata):
            yield ns, key, dict(self._metadata[(ns, key)])

    def get_state_range(self, ns: str, start: str,
                        end: str) -> List[Tuple[str, bytes, Version]]:
        keys = self._keys.get(ns, [])
        i = bisect.bisect_left(keys, start)
        out = []
        while i < len(keys):
            k = keys[i]
            if end and k >= end:
                break
            off, vlen, ver = self._keydir[(ns, k)]
            out.append((k, self._read_value(off, vlen), ver))
            i += 1
        return out

    @property
    def savepoint(self) -> int:
        return self._savepoint

    # -- writes ---------------------------------------------------------
    def apply_updates(self, batch: UpdateBatch, block_num: int) -> None:
        # the whole block's frames build into ONE bytearray -> one
        # buffered write + one flush/fsync (counted): frame headers
        # are patched in place after each body lands, so nothing is
        # allocated or syscalled per record
        blob = bytearray()
        n_frames = 0

        def begin() -> int:
            hdr = len(blob)
            blob.extend(b"\x00" * 8)
            return hdr

        def end(hdr: int) -> None:
            mv = memoryview(blob)[hdr + 8:]
            crc = zlib.crc32(mv)
            mv.release()
            struct.pack_into("<II", blob, hdr, len(blob) - hdr - 8, crc)

        def pack_str(s: bytes) -> None:
            blob.extend(struct.pack("<I", len(s)))
            blob.extend(s)

        staged = []                       # (ns, key, rel_val_off, vlen, ver)
        base = self._log_size
        for (ns, key), (value, version) in sorted(batch.updates.items()):
            hdr = begin()
            if value is None:
                blob.append(_DEL)
                pack_str(ns.encode())
                pack_str(key.encode())
                blob.extend(struct.pack("<qq", *version))
                staged.append((ns, key, -1, -1, None))
            else:
                blob.append(_PUT)
                pack_str(ns.encode())
                pack_str(key.encode())
                blob.extend(struct.pack("<qq", *version))
                blob.extend(struct.pack("<I", len(value)))
                staged.append((ns, key, len(blob), len(value), version))
                blob.extend(value)
            end(hdr)
            n_frames += 1
        staged_meta = []
        for (ns, key), (entries, version) in sorted(
                batch.meta_updates.items()):
            hdr = begin()
            blob.append(_META)
            pack_str(ns.encode())
            pack_str(key.encode())
            blob.extend(struct.pack("<qq", *version))
            blob.extend(struct.pack("<I", len(entries)))
            for name, val in sorted(entries.items()):
                pack_str(name.encode())
                pack_str(val)
            end(hdr)
            staged_meta.append((ns, key, entries, version))
            n_frames += 1
        hdr = begin()
        blob.append(_SAVE)
        blob.extend(struct.pack("<q", block_num))
        end(hdr)
        n_frames += 1
        self.batch_writes += 1
        self.batch_frames += n_frames
        self._f.write(blob)
        self._f.flush()
        os.fsync(self._f.fileno())
        for ns, key, rel, vlen, ver in staged:
            self._apply_mem(ns, key, base + rel if rel >= 0 else -1,
                            vlen, ver)
        for ns, key, entries, ver in staged_meta:
            self._apply_meta_mem(ns, key, entries, ver)
        self._log_size += len(blob)
        self._savepoint = block_num
        self._blocks_since_ckpt += 1
        if self._blocks_since_ckpt >= self.CKPT_EVERY:
            self._write_checkpoint()
            self._blocks_since_ckpt = 0
        if (self._log_size > self.COMPACT_MIN_BYTES and
                self._dead_bytes > self._log_size * self.COMPACT_DEAD_RATIO):
            self._compact()

    # -- compaction -------------------------------------------------------
    def _compact(self) -> None:
        """Rewrite live records into generation+1, drop the old log."""
        new_gen = self._gen + 1
        path = self._store._path("log", new_gen)
        new_keydir: Dict[Tuple[str, str], Tuple[int, int, Version]] = {}
        with open(path, "wb") as f:
            size = 0
            for (ns, key) in sorted(self._keydir):
                off, vlen, ver = self._keydir[(ns, key)]
                value = self._read_value(off, vlen)
                payload = io.BytesIO()
                payload.write(bytes([_PUT]))
                _pack_str(payload, ns.encode())
                _pack_str(payload, key.encode())
                payload.write(struct.pack("<qq", *ver))
                payload.write(struct.pack("<I", len(value)))
                val_off = size + 8 + payload.tell()
                payload.write(value)
                blob = _frame(payload.getvalue())
                f.write(blob)
                new_keydir[(ns, key)] = (val_off, len(value), ver)
                size += len(blob)
            for (ns, key), entries in sorted(self._metadata.items()):
                if (ns, key) not in new_keydir:
                    continue
                ver = new_keydir[(ns, key)][2]
                payload = io.BytesIO()
                payload.write(bytes([_META]))
                _pack_str(payload, ns.encode())
                _pack_str(payload, key.encode())
                payload.write(struct.pack("<qq", *ver))
                payload.write(struct.pack("<I", len(entries)))
                for name, val in sorted(entries.items()):
                    _pack_str(payload, name.encode())
                    _pack_str(payload, val)
                blob = _frame(payload.getvalue())
                f.write(blob)
                size += len(blob)
            f.write(_frame(bytes([_SAVE]) +
                           struct.pack("<q", self._savepoint)))
            size += 8 + 9
            f.flush()
            os.fsync(f.fileno())
        old_gen = self._gen
        self._gen = new_gen
        self._keydir = new_keydir
        self._log_size = size
        self._dead_bytes = 0
        self._f.close()
        self._fr.close()
        self._f = open(path, "a+b")
        self._fr = open(path, "rb")
        self._write_checkpoint()
        for kind in ("log", "ckpt"):
            old = self._store._path(kind, old_gen)
            if os.path.exists(old):
                os.remove(old)

    def close(self) -> None:
        self._write_checkpoint()
        self._f.close()
        self._fr.close()


class DurableHistoryDB:
    """Persisted key-history index (reference: kvledger/history/db.go):
    an append log of (block, tx, ns, key) postings + an index
    checkpoint, recovering in O(delta since checkpoint)."""

    CKPT_EVERY = 256

    def __init__(self, dir_path: str):
        self._store = _LogStore(dir_path, "hist")
        self._hist: Dict[Tuple[str, str], List[Version]] = {}
        self._savepoint = -1
        self._blocks_since_ckpt = 0
        self._open()

    def _open(self) -> None:
        path = self._store._path("log", 0)
        if not os.path.exists(path):
            open(path, "wb").close()
        raw = open(path, "rb").read()
        start = 0
        ckpt = self._store.read_checkpoint(0)
        if ckpt is not None:
            start = self._load_checkpoint(ckpt)
            if start > len(raw):
                start = 0
                self._hist.clear()
                self._savepoint = -1
        committed_end = start
        pending: List[Tuple[str, str, Version]] = []
        for end, payload in _iter_records(raw, start):
            kind = payload[0]
            if kind == _SAVE:
                (blk,) = struct.unpack_from("<q", payload, 1)
                for ns, key, ver in pending:
                    self._hist.setdefault((ns, key), []).append(ver)
                pending.clear()
                self._savepoint = blk
                committed_end = end
            elif kind == _POST:
                pos = 1
                (nl,) = struct.unpack_from("<I", payload, pos); pos += 4
                ns = payload[pos:pos + nl].decode(); pos += nl
                (kl,) = struct.unpack_from("<I", payload, pos); pos += 4
                key = payload[pos:pos + kl].decode(); pos += kl
                bn, tn = struct.unpack_from("<qq", payload, pos)
                pending.append((ns, key, (bn, tn)))
        if committed_end < len(raw):
            with open(path, "r+b") as f:
                f.truncate(committed_end)
        self._f = open(path, "a+b")
        self._log_size = committed_end

    def _load_checkpoint(self, body: bytes) -> int:
        pos = 0
        self._savepoint, watermark, count = struct.unpack_from(
            "<qqq", body, pos)
        pos += 24
        for _ in range(count):
            (nl,) = struct.unpack_from("<I", body, pos); pos += 4
            ns = body[pos:pos + nl].decode(); pos += nl
            (kl,) = struct.unpack_from("<I", body, pos); pos += 4
            key = body[pos:pos + kl].decode(); pos += kl
            (n,) = struct.unpack_from("<I", body, pos); pos += 4
            vers = []
            for _ in range(n):
                bn, tn = struct.unpack_from("<qq", body, pos)
                pos += 16
                vers.append((bn, tn))
            self._hist[(ns, key)] = vers
        return watermark

    def _write_checkpoint(self) -> None:
        buf = io.BytesIO()
        buf.write(struct.pack("<qqq", self._savepoint, self._log_size,
                              len(self._hist)))
        for (ns, key), vers in self._hist.items():
            _pack_str(buf, ns.encode())
            _pack_str(buf, key.encode())
            buf.write(struct.pack("<I", len(vers)))
            for bn, tn in vers:
                buf.write(struct.pack("<qq", bn, tn))
        self._store.write_checkpoint(0, buf.getvalue())

    @property
    def savepoint(self) -> int:
        return self._savepoint

    def commit(self, block_num: int,
               tx_writes: List[Tuple[int, str, str]]) -> None:
        if block_num <= self._savepoint:
            return                        # replay overlap: already have it
        frames = io.BytesIO()
        for tx_num, ns, key in tx_writes:
            payload = io.BytesIO()
            payload.write(bytes([_POST]))
            _pack_str(payload, ns.encode())
            _pack_str(payload, key.encode())
            payload.write(struct.pack("<qq", block_num, tx_num))
            frames.write(_frame(payload.getvalue()))
        frames.write(_frame(bytes([_SAVE]) + struct.pack("<q", block_num)))
        blob = frames.getvalue()
        self._f.write(blob)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._log_size += len(blob)
        for tx_num, ns, key in tx_writes:
            self._hist.setdefault((ns, key), []).append((block_num, tx_num))
        self._savepoint = block_num
        self._blocks_since_ckpt += 1
        if self._blocks_since_ckpt >= self.CKPT_EVERY:
            self._write_checkpoint()
            self._blocks_since_ckpt = 0

    def get_history_for_key(self, ns: str, key: str) -> List[Version]:
        return list(self._hist.get((ns, key), []))

    def close(self) -> None:
        self._write_checkpoint()
        self._f.close()
