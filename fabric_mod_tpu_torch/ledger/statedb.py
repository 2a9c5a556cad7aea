"""Versioned key-value state — the port's copy of
fabric_mod_tpu/ledger/statedb.py's in-memory store (reference:
core/ledger/kvledger/txmgmt/statedb/statedb.go `VersionedDB`,
`UpdateBatch`) with its whole-DB snapshot file (`snapshot` :159,
`load` :190): the state of a `KvLedger(durable=False)`, written
atomically every SNAPSHOT_EVERY blocks and on close, in the reference's
format.  A durable ledger keeps its state in ledger/durable.py instead.
"""
from __future__ import annotations

import bisect
import hashlib
import io
import os
import struct
from typing import Dict, List, Optional, Tuple

Version = Tuple[int, int]               # (block_num, tx_num)


class UpdateBatch:
    """Pending writes of one block, incl. the metadata writes key-level
    endorsement rides on."""

    def __init__(self):
        self.updates: Dict[Tuple[str, str], Tuple[Optional[bytes], Version]] = {}
        self.meta_updates: Dict[Tuple[str, str],
                                Tuple[Dict[str, bytes], Version]] = {}

    def put(self, ns: str, key: str, value: bytes, version: Version) -> None:
        self.updates[(ns, key)] = (value, version)

    def delete(self, ns: str, key: str, version: Version) -> None:
        self.updates[(ns, key)] = (None, version)

    def put_metadata(self, ns: str, key: str, entries: Dict[str, bytes],
                     version: Version) -> None:
        self.meta_updates[(ns, key)] = (dict(entries), version)

    def get(self, ns: str, key: str):
        return self.updates.get((ns, key))

    def __len__(self) -> int:
        return len(self.updates) + len(self.meta_updates)


class VersionedDB:
    """In-memory versioned KV with a per-namespace sorted key index
    (range queries are first-class: phantom detection re-runs them)."""

    def __init__(self):
        self._data: Dict[Tuple[str, str], Tuple[bytes, Version]] = {}
        self._metadata: Dict[Tuple[str, str], Dict[str, bytes]] = {}
        self._keys: Dict[str, List[str]] = {}       # ns -> sorted keys
        self._savepoint: int = -1                   # last committed block

    # -- reads -----------------------------------------------------------
    def get_state(self, ns: str, key: str):
        """-> (value, version) or None."""
        return self._data.get((ns, key))

    def get_version(self, ns: str, key: str) -> Optional[Version]:
        got = self._data.get((ns, key))
        return got[1] if got else None

    def get_versions_many(self, pairs) -> List[Optional[Version]]:
        """The committed versions of many (ns, key) pairs in one call:
        the vectorized MVCC's hash-join resolves every key a block
        touches here, once per block instead of once per read
        (reference: statedb.BulkOptimizable LoadCommittedVersions)."""
        data = self._data
        out = []
        for pair in pairs:
            got = data.get(pair)
            out.append(got[1] if got else None)
        return out

    def get_metadata(self, ns: str, key: str) -> Optional[Dict[str, bytes]]:
        """Key metadata (e.g. the VALIDATION_PARAMETER endorsement
        override)."""
        got = self._metadata.get((ns, key))
        return dict(got) if got else None

    def iter_state(self):
        """Deterministic full scan: (ns, key, value, version) sorted."""
        for (ns, key) in sorted(self._data):
            value, ver = self._data[(ns, key)]
            yield ns, key, value, ver

    def iter_metadata(self):
        """Deterministic full metadata scan: (ns, key, {name: value})."""
        for (ns, key) in sorted(self._metadata):
            yield ns, key, dict(self._metadata[(ns, key)])

    def get_state_range(self, ns: str, start: str,
                        end: str) -> List[Tuple[str, bytes, Version]]:
        """(key, value, version) list, start <= key < end ('' end =
        unbounded), in key order."""
        keys = self._keys.get(ns, [])
        i = bisect.bisect_left(keys, start)
        out = []
        while i < len(keys):
            k = keys[i]
            if end and k >= end:
                break
            v, ver = self._data[(ns, k)]
            out.append((k, v, ver))
            i += 1
        return out

    @property
    def savepoint(self) -> int:
        return self._savepoint

    # -- writes ----------------------------------------------------------
    def apply_updates(self, batch: UpdateBatch, block_num: int) -> None:
        for (ns, key), (value, version) in batch.updates.items():
            keys = self._keys.setdefault(ns, [])
            exists = (ns, key) in self._data
            if value is None:
                if exists:
                    del self._data[(ns, key)]
                    self._metadata.pop((ns, key), None)
                    keys.pop(bisect.bisect_left(keys, key))
            else:
                self._data[(ns, key)] = (value, version)
                if not exists:
                    bisect.insort(keys, key)
        for (ns, key), (entries, version) in batch.meta_updates.items():
            got = self._data.get((ns, key))
            if got is None:
                continue        # metadata without a key is a no-op
            # metadata writes bump the key version (MVCC visibility)
            self._data[(ns, key)] = (got[0], version)
            if entries:
                self._metadata[(ns, key)] = dict(entries)
            else:
                self._metadata.pop((ns, key), None)
        self._savepoint = block_num

    # -- durability ------------------------------------------------------
    MAGIC = b"FMTSDB2\n"

    def snapshot(self, path: str) -> None:
        """Atomic whole-DB snapshot (write-temp + rename)."""
        buf = io.BytesIO()
        buf.write(self.MAGIC)
        buf.write(struct.pack("<q", self._savepoint))
        buf.write(struct.pack("<I", len(self._data)))
        for (ns, key), (value, (bn, tn)) in sorted(self._data.items()):
            for part in (ns.encode(), key.encode(), value):
                buf.write(struct.pack("<I", len(part)))
                buf.write(part)
            buf.write(struct.pack("<QQ", bn, tn))
        buf.write(struct.pack("<I", len(self._metadata)))
        for (ns, key), entries in sorted(self._metadata.items()):
            for part in (ns.encode(), key.encode()):
                buf.write(struct.pack("<I", len(part)))
                buf.write(part)
            buf.write(struct.pack("<I", len(entries)))
            for name, val in sorted(entries.items()):
                for part in (name.encode(), val):
                    buf.write(struct.pack("<I", len(part)))
                    buf.write(part)
        payload = buf.getvalue()
        payload += hashlib.sha256(payload).digest()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "VersionedDB":
        db = cls()
        if not os.path.exists(path):
            return db
        raw = open(path, "rb").read()
        if len(raw) < 32 + len(cls.MAGIC):
            return db                       # torn snapshot: start empty
        body, digest = raw[:-32], raw[-32:]
        if hashlib.sha256(body).digest() != digest or \
                not body.startswith(cls.MAGIC):
            return db                       # corrupt: rebuild from blocks
        pos = len(cls.MAGIC)
        (db._savepoint,) = struct.unpack_from("<q", body, pos)
        pos += 8
        (count,) = struct.unpack_from("<I", body, pos)
        pos += 4
        for _ in range(count):
            parts = []
            for _ in range(3):
                (ln,) = struct.unpack_from("<I", body, pos)
                pos += 4
                parts.append(body[pos:pos + ln])
                pos += ln
            bn, tn = struct.unpack_from("<QQ", body, pos)
            pos += 16
            ns, key = parts[0].decode(), parts[1].decode()
            db._data[(ns, key)] = (parts[2], (bn, tn))
            db._keys.setdefault(ns, []).append(key)
        for keys in db._keys.values():     # bulk-sort, not insort^2
            keys.sort()
        (mcount,) = struct.unpack_from("<I", body, pos)
        pos += 4
        for _ in range(mcount):
            parts = []
            for _ in range(2):
                (ln,) = struct.unpack_from("<I", body, pos)
                pos += 4
                parts.append(body[pos:pos + ln])
                pos += ln
            (n_entries,) = struct.unpack_from("<I", body, pos)
            pos += 4
            entries = {}
            for _ in range(n_entries):
                pair = []
                for _ in range(2):
                    (ln,) = struct.unpack_from("<I", body, pos)
                    pos += 4
                    pair.append(body[pos:pos + ln])
                    pos += ln
                entries[pair[0].decode()] = pair[1]
            db._metadata[(parts[0].decode(), parts[1].decode())] = entries
        return db
