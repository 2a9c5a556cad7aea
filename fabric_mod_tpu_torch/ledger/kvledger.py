"""The kv ledger: blocks + versioned state, simulation, MVCC commit and
the state fingerprint.

The port of fabric_mod_tpu/ledger/kvledger.py (reference:
core/ledger/kvledger/kv_ledger.go:457 CommitLegacy; the tx simulator of
txmgmt/txmgr/lockbased_txmgr.go and query_executor.go; ledgermgmt's
ledger manager): `QueryExecutor` and `TxSimulator` (:61, :100),
`KvLedger.commit_block` (:369) — MVCC validate -> append the block
(flags in its metadata) -> apply the state batch — and `LedgerManager`
(:841).  Blocks live in a file-backed `BlockStore` (ledger/blkstorage.py),
in a temporary directory when the ledger is given none.  State is in
memory: on open, the block store's blocks are replayed into it from
their stored txflags.  Left out: the durable state DB, history, private data,
config history and snapshots.

`state_fingerprint` uses the reference's exact row, metadata and height
encoding (`_fp_row`, `_fp_meta`, `_fp_scan_acc`, `state_fingerprint`,
:688-785), so a port ledger and a JAX-package ledger that committed the
same blocks with the same flags give the same hex digest.  It scans the
whole state on every call (the reference folds each commit into a
cached accumulator; the digest is the same).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.ledger.blkstorage import BlockStore
from fabric_mod_tpu_torch.ledger.mvcc import validate_and_prepare_batch
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder, parse_tx_rwset
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch, VersionedDB
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

Version = Tuple[int, int]


class LedgerError(Exception):
    pass


class QueryExecutor:
    """Read-only state access (reference: query_executor.go)."""

    def __init__(self, db: VersionedDB):
        self._db = db

    def get_state(self, ns: str, key: str) -> Optional[bytes]:
        got = self._db.get_state(ns, key)
        return got[0] if got else None

    def get_state_range(self, ns: str, start: str, end: str):
        for key, value, _ in self._db.get_state_range(ns, start, end):
            yield key, value


class TxSimulator(QueryExecutor):
    """Records reads and writes into an RWSetBuilder (reference:
    lockbased_txmgr.go NewTxSimulator + rwset_builder).  Private data
    and rich queries are not ported."""

    def __init__(self, db: VersionedDB, txid: str):
        super().__init__(db)
        self.txid = txid
        self._rw = RWSetBuilder()
        self._writes: Dict[Tuple[str, str], Optional[bytes]] = {}

    def get_state(self, ns: str, key: str) -> Optional[bytes]:
        if (ns, key) in self._writes:       # read-your-writes
            return self._writes[(ns, key)]
        got = self._db.get_state(ns, key)
        self._rw.add_read(ns, key, got[1] if got else None)
        return got[0] if got else None

    def get_state_range(self, ns: str, start: str, end: str):
        """Range over committed state merged with this simulation's own
        writes.  The phantom fingerprint records committed results
        only: at validation the re-executed range sees earlier txs'
        writes but never this tx's own."""
        results = []
        merged = {}
        for key, value, ver in self._db.get_state_range(ns, start, end):
            results.append((key, ver))
            merged[key] = value
        self._rw.add_range_query(ns, start, end, True, results)
        for (wns, key), value in self._writes.items():
            if wns != ns or not (start <= key and (not end or key < end)):
                continue
            if value is None:
                merged.pop(key, None)
            else:
                merged[key] = value
        return iter(sorted(merged.items()))

    def set_state(self, ns: str, key: str, value: bytes) -> None:
        self._writes[(ns, key)] = value
        self._rw.add_write(ns, key, value)

    def delete_state(self, ns: str, key: str) -> None:
        self._writes[(ns, key)] = None
        self._rw.add_write(ns, key, None)

    def set_state_metadata(self, ns: str, key: str, name: str,
                           value: bytes) -> None:
        """Key metadata write, e.g. the VALIDATION_PARAMETER endorsement
        override that key-level validation reads."""
        self._rw.add_metadata_write(ns, key, name, value)

    def done(self) -> m.TxReadWriteSet:
        return self._rw.build()


def tx_rwset_from_envelope(env: m.Envelope) -> Optional[m.TxReadWriteSet]:
    """Envelope -> TxReadWriteSet of its (first) endorser action, or
    None when absent/malformed."""
    try:
        payload = protoutil.unmarshal_envelope_payload(env)
        tx = protoutil.extract_endorser_tx(payload)
        cca, _prp, _ends = protoutil.tx_rwset_and_endorsements(tx.actions[0])
        return m.TxReadWriteSet.decode(cca.results)
    except Exception:
        return None


def _fp_entry(tag: bytes, ns: str, key: str, tail: bytes) -> int:
    h = hashlib.sha256(tag)
    for part in (ns.encode(), key.encode()):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    h.update(tail)
    return int.from_bytes(h.digest(), "big")


def _fp_row(ns: str, key: str, value: bytes, ver: Version) -> int:
    tail = (len(value).to_bytes(4, "big") + value
            + ver[0].to_bytes(8, "big") + ver[1].to_bytes(8, "big"))
    return _fp_entry(b"S", ns, key, tail)


def _fp_meta(ns: str, key: str, entries: Dict[str, bytes]) -> int:
    parts = [len(entries).to_bytes(4, "big")]
    for name in sorted(entries):
        for part in (name.encode(), entries[name]):
            parts.append(len(part).to_bytes(4, "big"))
            parts.append(part)
    return _fp_entry(b"M", ns, key, b"".join(parts))


class KvLedger:
    """One channel's ledger (reference: kv_ledger.go kvLedger).

    The blocks go to a BlockStore under `<ledger_dir>/chains`, and
    reopening the directory replays them into the state.  `ledger_dir`
    None gives the ledger a temporary directory of its own, removed on
    `close()`."""

    def __init__(self, ledger_id: str = "ch",
                 ledger_dir: Optional[str] = None):
        self.ledger_id = ledger_id
        self._tmp = None
        if ledger_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="kvledger-")
            ledger_dir = self._tmp.name
        self.dir = ledger_dir
        self.state = VersionedDB()
        self._lock = threading.Lock()
        os.makedirs(ledger_dir, exist_ok=True)
        self.blockstore = BlockStore(os.path.join(ledger_dir, "chains"))
        for block in self.blockstore.iter_blocks():
            self._replay(block)

    def _replay(self, block: m.Block) -> None:
        """Re-derive a committed block's state updates from its stored
        txflags (no re-validation; reference: kv_ledger.go recovery)."""
        flags = protoutil.block_txflags(block)
        num = block.header.number
        batch = UpdateBatch()
        for tx_num, env in enumerate(protoutil.get_envelopes(block)):
            if flags[tx_num] != m.TxValidationCode.VALID:
                continue
            rwset = tx_rwset_from_envelope(env)
            if rwset is None:
                continue
            for ns, kv in parse_tx_rwset(rwset):
                for w in kv.writes:
                    if w.is_delete:
                        batch.delete(ns, w.key, (num, tx_num))
                    else:
                        batch.put(ns, w.key, w.value, (num, tx_num))
                for mw in kv.metadata_writes:
                    batch.put_metadata(ns, mw.key,
                                       {e.name: e.value for e in mw.entries},
                                       (num, tx_num))
        self.state.apply_updates(batch, num)

    # -- simulation ------------------------------------------------------
    def new_tx_simulator(self, txid: str) -> TxSimulator:
        return TxSimulator(self.state, txid)

    def new_query_executor(self) -> QueryExecutor:
        return QueryExecutor(self.state)

    # -- commit ----------------------------------------------------------
    def commit_block(self, block: m.Block,
                     incoming_flags: Optional[List[int]] = None) -> List[int]:
        """MVCC-validate + commit a block whose signature/policy
        verdicts are `incoming_flags` (defaults to the flags already in
        the block metadata).  Returns the final flags."""
        with self._lock:
            num = block.header.number
            if num != self.height:
                raise LedgerError(
                    f"commit out of order: {num} at height {self.height}")
            envs = protoutil.get_envelopes(block)
            if incoming_flags is None:
                # fail closed: absent metadata flags decode to
                # NOT_VALIDATED, never to VALID
                incoming_flags = list(protoutil.block_txflags(block))
            elif len(incoming_flags) != len(envs):
                raise LedgerError(
                    f"flags length {len(incoming_flags)} != "
                    f"{len(envs)} txs")
            txs = []
            for env, flag in zip(envs, incoming_flags):
                try:
                    ch = protoutil.envelope_channel_header(env)
                except Exception:
                    txs.append(("", None, m.TxValidationCode.BAD_PAYLOAD))
                    continue
                if ch.type != m.HeaderType.ENDORSER_TRANSACTION:
                    # config/control txs commit with no state effects
                    txs.append((ch.tx_id, m.TxReadWriteSet(), flag))
                else:
                    txs.append((ch.tx_id, tx_rwset_from_envelope(env), flag))
            flags, batch, _tx_writes = validate_and_prepare_batch(
                txs, self.state, num)
            protoutil.set_block_txflags(block, bytes(flags))
            self.blockstore.add_block(block)
            self.state.apply_updates(batch, num)
        return flags

    # -- queries ---------------------------------------------------------
    @property
    def height(self) -> int:
        return self.blockstore.height

    def get_block_by_number(self, num: int) -> Optional[m.Block]:
        return self.blockstore.get_block_by_number(num)

    def get_transaction_by_id(self, txid: str
                              ) -> Optional[m.ProcessedTransaction]:
        loc = self.blockstore.get_tx_loc(txid)
        if loc is None:
            return None
        block = self.blockstore.get_block_by_number(loc[0])
        flags = protoutil.block_txflags(block)
        return m.ProcessedTransaction(
            transaction_envelope=protoutil.get_envelopes(block)[loc[1]],
            validation_code=flags[loc[1]])

    def tx_id_exists(self, txid: str) -> bool:
        return self.blockstore.get_tx_loc(txid) is not None

    def state_fingerprint(self) -> str:
        """Digest of the entire committed state — every (ns, key,
        value, version) row, every key-metadata entry, and the chain
        height — equal to the reference ledger's for the same blocks
        and flags.  Taken under the commit lock."""
        with self._lock:
            acc = 0
            for ns, key, value, ver in self.state.iter_state():
                acc ^= _fp_row(ns, key, value, ver)
            for ns, key, entries in self.state.iter_metadata():
                acc ^= _fp_meta(ns, key, entries)
            h = hashlib.sha256(self.height.to_bytes(8, "big"))
            h.update(acc.to_bytes(32, "big"))
            return h.hexdigest()

    def close(self) -> None:
        with self._lock:
            self.blockstore.close()
            if self._tmp is not None:
                self._tmp.cleanup()


class LedgerManager:
    """Open/create ledgers by id under one directory (reference:
    ledgermgmt/ledger_mgmt.go)."""

    def __init__(self, root_dir: str):
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self._ledgers: Dict[str, KvLedger] = {}

    def create_or_open(self, ledger_id: str) -> KvLedger:
        if ledger_id not in self._ledgers:
            self._ledgers[ledger_id] = KvLedger(
                ledger_id, os.path.join(self.root, ledger_id))
        return self._ledgers[ledger_id]

    def ledger_ids(self) -> List[str]:
        existing = set(self._ledgers)
        existing.update(os.listdir(self.root))
        return sorted(existing)

    def close(self) -> None:
        for led in self._ledgers.values():
            led.close()
