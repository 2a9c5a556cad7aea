"""Private data: transient staging, the per-block private-data store,
BTL expiry and the hash gate.

The port's copy of fabric_mod_tpu/ledger/pvtdata.py: `_OpLog` (:30),
`pvt_namespace` (:119), `hash_key` / `hash_value`, `TransientStore`
(:133), `PvtDataStore` (:242) and `verify_pvt_against_hashes` (:434)
(reference: core/transientstore/store.go — endorsement-time staging of
private write-sets keyed by txid, purged below a block height —
core/ledger/pvtdatastorage/store.go — committed per-block private data
with block-to-live expiry — and the hash-consistency gate of
gossip/privdata/coordinator.go:498's StoreBlock).  Both stores' op-logs
and checkpoints are the reference's files, so a store directory opens
in either package.

Private values never enter blocks: a block carries each collection's
HASHED write set, the plaintext travels out of band (the transient
store, gossip distribution and reconciliation), and the commit checks
sha256(key) / sha256(value) against the block's hashes before it
applies the private writes to the ns$$p<collection> state namespace.
The ledger's commit lock is the outermost lock; the transient store's
nests inside it, and the pvt store's inside that.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import OrderedLock
from fabric_mod_tpu_torch.ledger.durable import _frame, _iter_records, _LogStore
from fabric_mod_tpu_torch.protos import messages as m


class _OpLog:
    """Tiny durable op-log + checkpoint for the pvt/transient stores
    (the durable.py log-structured pattern at JSON granularity — these
    stores hold orders of magnitude less data than the state DB, so
    debuggability wins over byte-packing; reference:
    core/ledger/pvtdatastorage/store.go and core/transientstore/
    store.go are leveldb instances).

    Records are length+crc framed JSON objects; recovery loads the
    newest intact checkpoint then replays the log, cropping a torn
    tail.  `append` keeps the file handle open; `fsync=True` records
    (per-block pvt commits) are durable at return."""

    CKPT_EVERY = 4096                     # records between checkpoints

    def __init__(self, dir_path: str, name: str):
        self._store = _LogStore(dir_path, name)
        self._fh = None
        self._pending = 0

    def recover(self, load_checkpoint, apply_record) -> None:
        gens = self._store.generations()
        gen = gens[-1] if gens else 0
        self._gen = gen
        body = self._store.read_checkpoint(gen)
        if body is not None:
            load_checkpoint(json.loads(body.decode()))
        path = self._store._path("log", gen)
        good_end = 0
        if os.path.exists(path):
            buf = open(path, "rb").read()
            for end, payload in _iter_records(buf, 0):
                apply_record(json.loads(payload.decode()))
                good_end = end
                self._pending += 1
            if good_end < len(buf):        # crop torn tail
                with open(path, "r+b") as f:
                    f.truncate(good_end)
        self._fh = open(path, "ab")

    def append(self, rec: dict, fsync: bool = False) -> None:
        self._fh.write(_frame(json.dumps(rec).encode()))
        self._fh.flush()
        if fsync:
            os.fsync(self._fh.fileno())
        self._pending += 1

    def sync(self) -> None:
        """Durability barrier: everything appended so far is on disk."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def maybe_checkpoint(self, dump_checkpoint) -> None:
        if self._pending < self.CKPT_EVERY:
            return
        self.checkpoint(dump_checkpoint)

    def checkpoint(self, dump_checkpoint) -> None:
        new_gen = self._gen + 1
        self._store.write_checkpoint(
            new_gen, json.dumps(dump_checkpoint()).encode())
        self._fh.close()
        old = self._store._path("log", self._gen)
        old_ckpt = self._store._path("ckpt", self._gen)
        self._fh = open(self._store._path("log", new_gen), "ab")
        for path in (old, old_ckpt):
            if os.path.exists(path):
                os.remove(path)
        self._gen = new_gen
        self._pending = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def pvt_namespace(ns: str, collection: str) -> str:
    """The state-DB namespace private writes land in (reference:
    privacyenabledstate's ns/collection composite namespaces)."""
    return f"{ns}$$p{collection}"


def hash_key(key: str) -> bytes:
    return hashlib.sha256(key.encode()).digest()


def hash_value(value: bytes) -> bytes:
    return hashlib.sha256(value).digest()


class TransientStore:
    """Endorsement-time private write-set staging (reference:
    core/transientstore/store.go — Persist/GetTxPvtRWSetByTxid/
    PurgeBelowHeight).  Bounded: gossip-delivered plaintext is
    attacker-influenceable, so growth past `max_entries` drops new
    arrivals (commit-time reconciliation recovers them later) instead
    of growing without bound."""

    MAX_ENTRIES = 10_000

    def __init__(self, max_entries: int = MAX_ENTRIES,
                 dir_path: Optional[str] = None):
        """`dir_path` makes the store durable: pending private
        plaintext survives a peer restart (reference: the leveldb
        transientstore) — without it, endorsement-time staging is lost
        on crash and must be re-reconciled from peers."""
        # nests inside the ledger's commit lock
        self._lock = OrderedLock(20, "transientstore")
        self._max = max_entries
        self._count = 0
        # txid -> [(received_at_block, TxPvtReadWriteSet bytes)]
        self._data: Dict[str, List[Tuple[int, bytes]]] = {}
        self._log: Optional[_OpLog] = None
        if dir_path is not None:
            self._log = _OpLog(dir_path, "transient")
            self._log.recover(self._load_ckpt, self._apply)

    # -- durability plumbing ----------------------------------------------
    def _load_ckpt(self, ck: dict) -> None:
        self._data = {t: [(h, _unb64(r)) for h, r in entries]
                      for t, entries in ck["data"].items()}
        self._count = sum(len(v) for v in self._data.values())

    def _dump_ckpt(self) -> dict:
        return {"data": {t: [[h, _b64(r)] for h, r in entries]
                         for t, entries in self._data.items()}}

    def _apply(self, rec: dict) -> None:
        op = rec["op"]
        if op == "persist":
            self._persist_mem(rec["txid"], rec["h"], _unb64(rec["raw"]))
        elif op == "purge_txids":
            self._purge_txids_mem(rec["txids"])
        elif op == "purge_below":
            self._purge_below_mem(rec["h"])

    def _record(self, rec: dict) -> None:
        if self._log is not None:
            self._log.append(rec)
            self._log.maybe_checkpoint(self._dump_ckpt)

    # -- operations --------------------------------------------------------
    def _persist_mem(self, txid: str, received_at_block: int,
                     raw: bytes) -> bool:
        entries = self._data.setdefault(txid, [])
        if any(r == raw for _, r in entries):
            return False                  # N endorsers, one copy
        if self._count >= self._max:
            if not entries:
                del self._data[txid]
            return False                  # flood guard: drop new
        entries.append((received_at_block, raw))
        self._count += 1
        return True

    def persist(self, txid: str, received_at_block: int,
                pvt_rwset: m.TxPvtReadWriteSet) -> None:
        raw = pvt_rwset.encode()
        with self._lock:
            if self._persist_mem(txid, received_at_block, raw):
                self._record({"op": "persist", "txid": txid,
                              "h": received_at_block, "raw": _b64(raw)})

    def get_by_txid(self, txid: str) -> List[m.TxPvtReadWriteSet]:
        with self._lock:
            return [m.TxPvtReadWriteSet.decode(raw)
                    for _, raw in self._data.get(txid, [])]

    def _purge_txids_mem(self, txids) -> None:
        for t in txids:
            gone = self._data.pop(t, None)
            if gone:
                self._count -= len(gone)

    def purge_by_txids(self, txids) -> None:
        with self._lock:
            self._purge_txids_mem(txids)
            self._record({"op": "purge_txids", "txids": list(txids)})

    def _purge_below_mem(self, height: int) -> None:
        for txid in list(self._data):
            kept = [(h, raw) for h, raw in self._data[txid]
                    if h >= height]
            self._count -= len(self._data[txid]) - len(kept)
            if kept:
                self._data[txid] = kept
            else:
                del self._data[txid]

    def purge_below_height(self, height: int) -> None:
        """(reference: PurgeBelowHeight — endorsement leftovers)"""
        with self._lock:
            self._purge_below_mem(height)
            self._record({"op": "purge_below", "h": height})

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


class PvtDataStore:
    """Committed private data per (block, tx, ns, collection) with
    BTL-based expiry (reference: pvtdatastorage/store.go +
    pvtstatepurgemgmt).  In-memory index; the authoritative private
    STATE lives in the (durable) state DB's pvt namespaces — this
    store serves history/retrieval and drives purges."""

    def __init__(self, dir_path: Optional[str] = None):
        """`dir_path` makes the store durable: committed private
        plaintext AND the pending-reconciliation (missing-digest) index
        survive a peer restart (reference: the leveldb-backed
        pvtdatastorage/store.go); without it the plaintext must be
        re-reconciled from peers after a crash."""
        # nests inside the transient store's lock
        self._lock = OrderedLock(30, "pvtdatastore")
        # (block, tx) -> [(ns, collection, KVRWSet bytes)]
        self._by_block: Dict[Tuple[int, int],
                             List[Tuple[str, str, bytes]]] = {}
        # expiry_block -> [(block, tx, ns, collection, [keys])]
        self._expiries: Dict[int, List] = {}
        # hashed writes committed WITHOUT plaintext — the reconciler's
        # work list (reference: pvtdatastorage's missing-data index +
        # reconcile.go:339)
        self._missing: set = set()   # (block, tx, ns, collection)
        self._log: Optional[_OpLog] = None
        if dir_path is not None:
            self._log = _OpLog(dir_path, "pvtdata")
            self._log.recover(self._load_ckpt, self._apply)

    # -- durability plumbing ----------------------------------------------
    def _load_ckpt(self, ck: dict) -> None:
        self._by_block = {
            (bn, tn): [(n, c, _unb64(r)) for n, c, r in entries]
            for (bn, tn), entries in
            ((tuple(json.loads(k)), v)
             for k, v in ck["by_block"].items())}
        self._expiries = {int(k): [tuple(e[:4]) + (e[4],) for e in v]
                          for k, v in ck["expiries"].items()}
        self._missing = {tuple(d) for d in ck["missing"]}

    def _dump_ckpt(self) -> dict:
        return {
            "by_block": {json.dumps(list(bt)): [[n, c, _b64(r)]
                                                for n, c, r in entries]
                         for bt, entries in self._by_block.items()},
            "expiries": {str(k): [list(e[:4]) + [list(e[4])] for e in v]
                         for k, v in self._expiries.items()},
            "missing": [list(d) for d in sorted(self._missing)],
        }

    def _apply(self, rec: dict) -> None:
        op = rec["op"]
        if op == "commit":
            self._commit_mem(rec["bn"], rec["tn"], rec["ns"], rec["c"],
                             _unb64(rec["kv"]), rec["btl"])
        elif op == "missing":
            self._missing.add((rec["bn"], rec["tn"], rec["ns"],
                               rec["c"]))
        elif op == "drop_missing":
            self._missing.discard((rec["bn"], rec["tn"], rec["ns"],
                                   rec["c"]))
        elif op == "purge":
            self._purge_mem(rec["bn"])

    def _record(self, rec: dict, fsync: bool = False) -> None:
        if self._log is not None:
            self._log.append(rec, fsync=fsync)
            self._log.maybe_checkpoint(self._dump_ckpt)

    def _commit_mem(self, block_num: int, tx_num: int, ns: str,
                    collection: str, raw: bytes, btl: int) -> None:
        self._by_block.setdefault((block_num, tx_num), []).append(
            (ns, collection, raw))
        self._missing.discard((block_num, tx_num, ns, collection))
        if btl > 0:
            keys = [w.key for w in m.KVRWSet.decode(raw).writes]
            self._expiries.setdefault(block_num + btl + 1, []).append(
                (block_num, tx_num, ns, collection, keys))

    def commit(self, block_num: int, tx_num: int, ns: str,
               collection: str, kv: m.KVRWSet, btl: int) -> None:
        raw = kv.encode()
        with self._lock:
            self._commit_mem(block_num, tx_num, ns, collection, raw, btl)
            # no per-record fsync: the ledger calls sync() ONCE per
            # block after all collections are processed (committed
            # plaintext must survive restarts — it may no longer be
            # reconcilable if peers purged by BTL — but one barrier
            # per block is enough)
            self._record({"op": "commit", "bn": block_num,
                          "tn": tx_num, "ns": ns, "c": collection,
                          "kv": _b64(raw), "btl": btl})

    # -- missing-data index (reconciler work list) ------------------------
    def report_missing(self, block_num: int, tx_num: int, ns: str,
                       collection: str) -> None:
        with self._lock:
            self._missing.add((block_num, tx_num, ns, collection))
            self._record({"op": "missing", "bn": block_num,
                          "tn": tx_num, "ns": ns, "c": collection})

    def missing(self, limit: int = 50) -> List[Tuple[int, int, str, str]]:
        """Oldest-first batch of unreconciled digests."""
        with self._lock:
            return sorted(self._missing)[:limit]

    def missing_count(self) -> int:
        """Total reconciliation backlog (the observability answer to
        'is a long outage draining at 50 digests/tick?' — exported as
        a gauge by the gossip reconciler)."""
        with self._lock:
            return len(self._missing)

    def drop_missing(self, block_num: int, tx_num: int, ns: str,
                     collection: str) -> None:
        """Give up on a digest (e.g. its BTL lapsed before any peer
        supplied the data)."""
        with self._lock:
            self._missing.discard((block_num, tx_num, ns, collection))
            self._record({"op": "drop_missing", "bn": block_num,
                          "tn": tx_num, "ns": ns, "c": collection})

    def is_missing(self, block_num: int, tx_num: int, ns: str,
                   collection: str) -> bool:
        with self._lock:
            return (block_num, tx_num, ns, collection) in self._missing

    def get(self, block_num: int, tx_num: int
            ) -> List[Tuple[str, str, m.KVRWSet]]:
        with self._lock:
            return [(ns, coll, m.KVRWSet.decode(raw))
                    for ns, coll, raw in
                    self._by_block.get((block_num, tx_num), [])]

    def later_written_keys(self, block_num: int, tx_num: int, ns: str,
                           collection: str) -> set:
        """Keys touched by committed private write-sets NEWER than
        (block_num, tx_num) in this collection — deletes leave no
        version in the state DB, so the reconciler must consult this
        before backfilling old writes (else it would resurrect deleted
        keys).  One scan serves every key of a backfilled set."""
        keys: set = set()
        with self._lock:
            for (bn, tn), entries in self._by_block.items():
                if (bn, tn) <= (block_num, tx_num):
                    continue
                for n, c, raw in entries:
                    if n == ns and c == collection:
                        kv = m.KVRWSet.decode(raw)
                        keys.update(w.key for w in kv.writes)
        return keys

    def expiring_at(self, block_num: int) -> List:
        """[(block, tx, ns, collection, keys)] whose BTL lapses when
        `block_num` commits (the purge manager's work list)."""
        with self._lock:
            return list(self._expiries.get(block_num, []))

    def _purge_mem(self, block_num: int) -> None:
        for bn, tn, ns, coll, _keys in \
                self._expiries.pop(block_num, []):
            entries = self._by_block.get((bn, tn))
            if not entries:
                continue
            kept = [(n, c, raw) for n, c, raw in entries
                    if not (n == ns and c == coll)]
            if kept:
                self._by_block[(bn, tn)] = kept
            else:
                del self._by_block[(bn, tn)]

    def purge(self, block_num: int) -> None:
        with self._lock:
            had = block_num in self._expiries
            self._purge_mem(block_num)
            if had:
                self._record({"op": "purge", "bn": block_num})

    def sync(self) -> None:
        """Per-block durability barrier (called by the ledger after a
        block's private data is fully processed)."""
        if self._log is not None:
            self._log.sync()

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


class PvtDataMismatchError(Exception):
    pass


def verify_pvt_against_hashes(hashed: m.HashedRWSet,
                              pvt_kv: m.KVRWSet) -> None:
    """The commit gate: plaintext private writes must match the
    block's hashed write-set exactly (reference: the coordinator's
    hash checks before StorePvtData)."""
    want = {(w.key_hash, w.value_hash, w.is_delete)
            for w in hashed.hashed_writes}
    got = {(hash_key(w.key),
            b"" if w.is_delete else hash_value(w.value),
            w.is_delete)
           for w in pvt_kv.writes}
    if want != got:
        raise PvtDataMismatchError(
            "private write-set does not match block hashes")
