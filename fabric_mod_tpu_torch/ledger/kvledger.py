"""The kv ledger: block store + versioned state + history + private data,
with simulation, MVCC commit, crash recovery and the state fingerprint.

The port of fabric_mod_tpu/ledger/kvledger.py (reference:
core/ledger/kvledger/kv_ledger.go — CommitLegacy :457-541, recoverDBs
:228-341; the tx simulator of txmgmt/txmgr/lockbased_txmgr.go and
query_executor.go; history in kvledger/history/db.go; ledgermgmt's
ledger manager): `QueryExecutor` and `TxSimulator` with private data,
`HistoryDB`, `KvLedger` and `LedgerManager`.

The commit order is the reference's: MVCC validate -> append the block
(flags in its metadata) -> apply the state batch -> history -> private
data -> config history.  `commit_block` takes the validator's
stage-time columnar decode (protos/batchdecode.BlockRWSets), reuses its
tx ids and header types, and sends the decoded rows through the
vectorized MVCC over its planes; a tx that carries collection hashes
keeps its materialized rwset while a transient store is attached,
because `_commit_pvt` walks those hashes.

A ledger is durable by default, as in the reference: the state is a
log-structured DurableStateDB and the history a DurableHistoryDB
(ledger/durable.py), each with one fsync per block, beside the
collection-config history (ledger/confighistory.py).  On open, blocks
past the lowest of the three savepoints are replayed from the block
store with their stored flags — O(delta), not O(chain); a state ahead
of a cropped block store is rebuilt from genesis.  `durable=False`
keeps state and history in memory, the state snapshotted to
`state.snap` every SNAPSHOT_EVERY blocks and on close.

`state_fingerprint` is height ‖ an XOR of per-entry hashes in the
reference's encoding, so both packages give the same hex digest for
the same blocks and flags.  The first call scans the state to seed the
accumulator; every later state change — commit, private plaintext, BTL
purge, reconciliation backfill, replay — goes through
`_apply_state_updates`, which folds its delta in first.
`state_fingerprint_full` rescans from scratch (the oracle).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import OrderedLock
from fabric_mod_tpu_torch.ledger import richquery
from fabric_mod_tpu_torch.ledger.blkstorage import BlockStore
from fabric_mod_tpu_torch.ledger.confighistory import ConfigHistoryManager
from fabric_mod_tpu_torch.ledger.durable import (DurableHistoryDB,
                                                 DurableStateDB)
from fabric_mod_tpu_torch.ledger.mvcc import (
    COLUMNAR, validate_and_prepare_batch,
    validate_and_prepare_batch_vectorized)
from fabric_mod_tpu_torch.ledger.pvtdata import (
    PvtDataMismatchError, pvt_namespace, verify_pvt_against_hashes)
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder, parse_tx_rwset
from fabric_mod_tpu_torch.ledger.snapshot import generate_snapshot
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch, VersionedDB
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

# the reference's G_HEIGHT (kvledger.py:52): set after each commit
_HEIGHT_OPTS = MetricOpts("ledger", "", "blockchain_height",
                          "Committed chain height", ("channel",))


def _height_gauge():
    return default_provider().gauge(_HEIGHT_OPTS)

Version = Tuple[int, int]


class LedgerError(Exception):
    pass


class QueryExecutor:
    """Read-only state access (reference: query_executor.go)."""

    def __init__(self, db):
        self._db = db

    def get_state(self, ns: str, key: str) -> Optional[bytes]:
        got = self._db.get_state(ns, key)
        return got[0] if got else None

    def get_state_range(self, ns: str, start: str, end: str):
        for key, value, _ in self._db.get_state_range(ns, start, end):
            yield key, value

    def get_private_data(self, ns: str, collection: str,
                         key: str) -> Optional[bytes]:
        got = self._db.get_state(pvt_namespace(ns, collection), key)
        return got[0] if got else None

    def _execute_query_versioned(self, ns: str, query):
        """The rich-query core: ([(key, doc, version)], bookmark).  A
        bookmark bounds the scan's start (`richquery.execute` skips the
        boundary key itself), so a page costs what remains."""
        q = richquery.RichQuery.parse(query)
        start = q.bookmark if (q.bookmark and not q.sort) else ""
        return richquery.execute(self._db.get_state_range(ns, start, ""), q)

    def execute_query(self, ns: str, query):
        """Rich JSON-selector query over a namespace (reference:
        statecouchdb.go:1230 ExecuteQuery): ([(key, doc)], bookmark)."""
        matches, bookmark = self._execute_query_versioned(ns, query)
        return [(k, doc) for k, doc, _ver in matches], bookmark


class TxSimulator(QueryExecutor):
    """Records reads and writes into an RWSetBuilder (reference:
    lockbased_txmgr.go NewTxSimulator + rwset_builder)."""

    def __init__(self, db, txid: str):
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

    def execute_query(self, ns: str, query):
        """A rich query during simulation: each returned key joins the
        read set, but the query is not re-executed at validation (no
        phantom protection for rich queries, as in the reference)."""
        matches, bookmark = self._execute_query_versioned(ns, query)
        out = []
        for key, doc, ver in matches:
            self._rw.add_read(ns, key, ver)
            out.append((key, doc))
        return out, bookmark

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

    # -- private data (reference: the shim's PutPrivateData path) -----
    def set_private_data(self, ns: str, collection: str, key: str,
                         value: bytes) -> None:
        self._writes[(pvt_namespace(ns, collection), key)] = value
        self._rw.add_pvt_write(ns, collection, key, value)

    def delete_private_data(self, ns: str, collection: str,
                            key: str) -> None:
        self._writes[(pvt_namespace(ns, collection), key)] = None
        self._rw.add_pvt_write(ns, collection, key, None)

    def get_private_data(self, ns: str, collection: str,
                         key: str) -> Optional[bytes]:
        pns = pvt_namespace(ns, collection)
        if (pns, key) in self._writes:      # read-your-writes
            return self._writes[(pns, key)]
        # private reads are not recorded in the public read set (the
        # reference's write-only private MVCC)
        got = self._db.get_state(pns, key)
        return got[0] if got else None

    def done(self) -> m.TxReadWriteSet:
        return self._rw.build()

    def done_pvt(self) -> Optional[m.TxPvtReadWriteSet]:
        """The plaintext private write sets, for transient staging."""
        return self._rw.build_pvt()


class HistoryDB:
    """(ns, key) -> [(block, tx), ...] in memory, rebuilt from the
    blocks on every open (reference: kvledger/history/db.go)."""

    savepoint = -1

    def __init__(self):
        self._hist: Dict[Tuple[str, str], List[Version]] = {}

    def commit(self, block_num: int,
               tx_writes: List[Tuple[int, str, str]]) -> None:
        for tx_num, ns, key in tx_writes:
            self._hist.setdefault((ns, key), []).append((block_num, tx_num))

    def get_history_for_key(self, ns: str, key: str) -> List[Version]:
        return list(self._hist.get((ns, key), []))


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


def _find_matching_pvt(candidates, ns: str, coll: str, hset):
    """The first candidate write set for (ns, coll) whose plaintext
    matches the block's hashes, or None."""
    for cand in candidates:
        for ns_pvt in cand.ns_pvt_rwset:
            if ns_pvt.namespace != ns:
                continue
            for cp in ns_pvt.collection_pvt_rwset:
                if cp.collection_name != coll:
                    continue
                kv = m.KVRWSet.decode(cp.rwset)
                try:
                    verify_pvt_against_hashes(hset, kv)
                    return kv
                except PvtDataMismatchError:
                    continue               # forged or stale candidate
    return None


class KvLedger:
    """One channel's ledger (reference: kv_ledger.go kvLedger).

    The blocks go to a BlockStore under `<ledger_dir>/chains`; durable
    state, history, config history and (through a Channel) the private
    data stores live beside it.  `ledger_dir` None gives the ledger a
    temporary directory of its own, removed on `close()`.
    `height_changed` is notified after each commit, once the block is
    readable and outside the commit lock: the deliver fan-out's commit
    notifier parks on it.  The commit lock is the outermost lock; the
    attached transient and pvt stores' locks nest inside it."""

    SNAPSHOT_EVERY = 64
    TRANSIENT_RETENTION_BLOCKS = 100

    def __init__(self, ledger_id: str = "ch",
                 ledger_dir: Optional[str] = None, durable: bool = True):
        self.ledger_id = ledger_id
        self._tmp = None
        if ledger_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="kvledger-")
            ledger_dir = self._tmp.name
        self.dir = ledger_dir
        self._durable = durable
        os.makedirs(ledger_dir, exist_ok=True)
        self._lock = OrderedLock(10, "kvledger")
        self.height_changed = threading.Condition()
        self.blockstore = BlockStore(os.path.join(ledger_dir, "chains"))
        self._state_path = os.path.join(ledger_dir, "state.snap")
        if durable:
            self.state = DurableStateDB(os.path.join(ledger_dir, "state"))
            self.history = DurableHistoryDB(
                os.path.join(ledger_dir, "history"))
        else:
            self.state = VersionedDB.load(self._state_path)
            self.history = HistoryDB()
        # attach_pvt wires the live stores; without them, hashed
        # collections commit without plaintext
        self._transient = None
        self._pvtstore = None
        self._btl_fn = None
        # the fingerprint accumulator: None until the first fingerprint
        # seeds it with a full scan
        self._fp_acc: Optional[int] = None
        self.confighistory = ConfigHistoryManager(
            os.path.join(ledger_dir, "confighistory.jsonl"))
        # the blocks whose state the last open re-applied
        self.replayed_blocks = 0
        self._recover()

    @property
    def durable(self) -> bool:
        return self._durable

    def attach_pvt(self, transient_store, pvtdata_store,
                   btl_fn=None) -> None:
        """Wire the transient and pvt stores (reference: the coordinator
        binding of gossip/privdata/coordinator.go:498)."""
        self._transient = transient_store
        self._pvtstore = pvtdata_store
        self._btl_fn = btl_fn or (lambda ns, coll: 0)

    def _reset_state_db(self) -> None:
        """The state ran ahead of a cropped block store: rebuild it from
        genesis (reference: the kv_ledger.go recovery edge)."""
        if self._durable:
            self.state.close()
            shutil.rmtree(os.path.join(self.dir, "state"))
            self.state = DurableStateDB(os.path.join(self.dir, "state"))
        else:
            self.state = VersionedDB()
        self._fp_acc = None

    # -- recovery --------------------------------------------------------
    def _recover(self) -> None:
        """Replay the blocks past the savepoints (reference:
        kv_ledger.go:239 syncStateAndHistoryDBWithBlockstore).  State
        is re-applied only past its own savepoint; history and config
        history are idempotent on the overlap."""
        height = self.blockstore.height
        if self.state.savepoint >= height:
            self._reset_state_db()
        hist_sp = self.history.savepoint
        if hist_sp >= height and self._durable:
            self.history.close()
            shutil.rmtree(os.path.join(self.dir, "history"))
            self.history = DurableHistoryDB(
                os.path.join(self.dir, "history"))
            hist_sp = -1
        # config history writes after the state commit, so its
        # savepoint can trail the state's by one block after a crash
        start = min(self.state.savepoint, hist_sp,
                    self.confighistory.savepoint) + 1
        for block in self.blockstore.iter_blocks(max(0, start)):
            replay_state = block.header.number > self.state.savepoint
            self._apply_block_effects(block, replay_state=replay_state)
            self.replayed_blocks += replay_state

    def _apply_block_effects(self, block: m.Block,
                             replay_state: bool) -> None:
        """Re-derive a committed block's state, history and config
        history updates from its stored txflags (no re-validation)."""
        flags = protoutil.block_txflags(block)
        num = block.header.number
        batch = UpdateBatch()
        hist: List[Tuple[int, str, str]] = []
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
                    hist.append((tx_num, ns, w.key))
                for mw in kv.metadata_writes:
                    batch.put_metadata(ns, mw.key,
                                       {e.name: e.value for e in mw.entries},
                                       (num, tx_num))
        if replay_state:
            self._apply_state_updates(batch, num)
        self.history.commit(num, hist)
        self.confighistory.handle_block_writes(
            num, [(ns, key, value)
                  for (ns, key), (value, _v) in batch.updates.items()])

    # -- simulation ------------------------------------------------------
    def new_tx_simulator(self, txid: str) -> TxSimulator:
        return TxSimulator(self.state, txid)

    def new_query_executor(self) -> QueryExecutor:
        return QueryExecutor(self.state)

    # -- commit ----------------------------------------------------------
    def commit_block(self, block: m.Block,
                     incoming_flags: Optional[List[int]] = None,
                     rwsets=None) -> List[int]:
        """MVCC-validate + commit a block whose signature/policy
        verdicts are `incoming_flags` (defaults to the flags already in
        the block metadata).  Returns the final flags.  `rwsets`
        (batchdecode.BlockRWSets | None), the validator's stage-time
        columnar decode: its tx ids and header types are reused instead
        of re-decoded, and its decoded rows take the vectorized MVCC
        (the same flags as the generic pass, which takes the rows the
        decode fell back on, the pvt-bearing rows while a transient
        store is attached, and blocks committed without `rwsets`)."""
        with self._lock:
            num = block.header.number
            if num != self.height:
                raise LedgerError(
                    f"commit out of order: {num} at height {self.height}")
            # "mvcc" covers the commit side's envelope decode, rwset
            # extraction and version compares (reference :402, whose
            # span leaves the envelope decode out: here it is in, so the
            # commit bucket's substages explain it)
            with tracing.span("mvcc", block=num):
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
                any_col = False
                for tx_num, (env, flag) in enumerate(
                        zip(envs, incoming_flags)):
                    if rwsets is not None and rwsets.txids[tx_num] is not None:
                        # stage-time spine facts, value-identical to the
                        # generic header decode below
                        txid = rwsets.txids[tx_num]
                        ch_type = rwsets.types[tx_num]
                    else:
                        try:
                            ch = protoutil.envelope_channel_header(env)
                            txid, ch_type = ch.tx_id, ch.type
                        except Exception:
                            txs.append(
                                ("", None, m.TxValidationCode.BAD_PAYLOAD))
                            continue
                    if ch_type != m.HeaderType.ENDORSER_TRANSACTION:
                        # config/control txs commit with no state effects
                        txs.append((txid, m.TxReadWriteSet(), flag))
                    elif rwsets is not None and \
                            rwsets.bodies[tx_num] is not None and \
                            (self._transient is None
                             or not rwsets.bodies[tx_num].has_pvt):
                        # a pvt-bearing tx keeps its materialized rwset
                        # while a transient store is wired: _commit_pvt
                        # walks its collection hashes
                        txs.append((txid, COLUMNAR, flag))
                        any_col = True
                    else:
                        txs.append((txid, tx_rwset_from_envelope(env), flag))
                if any_col:
                    flags, batch, tx_writes = \
                        validate_and_prepare_batch_vectorized(
                            txs, self.state, num, rwsets)
                else:
                    flags, batch, tx_writes = validate_and_prepare_batch(
                        txs, self.state, num)
            protoutil.set_block_txflags(block, bytes(flags))
            with tracing.span("ledger_write", block=num):
                self.blockstore.add_block(block)
                # the recovery contract's crash window: the block is
                # durable in the block store, none of the effects below
                # are yet; an armed error-mode rule kills the commit
                # here (reference :457)
                faults.point("peer.ledger.crash")
                self._apply_state_updates(batch, num)
                # per-tx writes (not the deduped batch), so commit and
                # replay record the same history
                self.history.commit(num, tx_writes)
                self._commit_pvt(num, txs, flags)
                self.confighistory.handle_block_writes(
                    num, [(ns, key, value) for (ns, key), (value, _v)
                          in batch.updates.items()])
            _height_gauge().with_labels(self.ledger_id).set(
                self.blockstore.height)
            if not self._durable and (num + 1) % self.SNAPSHOT_EVERY == 0:
                self.state.snapshot(self._state_path)
        with self.height_changed:
            self.height_changed.notify_all()
        return flags

    def _commit_pvt(self, num: int, txs, flags) -> None:
        """Apply the plaintext private writes of VALID txs whose hashes
        the block carries, taken from the transient store and checked
        against those hashes; then purge the transient store and run
        the BTL purges (reference: coordinator.go:498 StoreBlock +
        pvtstatepurgemgmt)."""
        if self._transient is None:
            return
        batch = UpdateBatch()
        for tx_num, (txid, rwset, _flag) in enumerate(txs):
            if flags[tx_num] != m.TxValidationCode.VALID or rwset is None:
                continue
            if rwset is COLUMNAR:
                # columnar rows are only taken for bodies without
                # collection hashes
                continue
            hashed = {}                    # (ns, coll) -> HashedRWSet
            for ns_entry in rwset.ns_rwset:
                for ch in ns_entry.collection_hashed_rwset:
                    hashed[(ns_entry.namespace, ch.collection_name)] = \
                        m.HashedRWSet.decode(ch.hashed_rwset)
            if not hashed:
                continue
            candidates = self._transient.get_by_txid(txid)
            for (ns, coll), hset in hashed.items():
                kv = _find_matching_pvt(candidates, ns, coll, hset)
                if kv is None:
                    # missing: record the digest, so the reconciler can
                    # pull it from an eligible peer later
                    self._pvtstore.report_missing(num, tx_num, ns, coll)
                    continue
                pns = pvt_namespace(ns, coll)
                for w in kv.writes:
                    if w.is_delete:
                        batch.delete(pns, w.key, (num, tx_num))
                    else:
                        batch.put(pns, w.key, w.value, (num, tx_num))
                self._pvtstore.commit(num, tx_num, ns, coll, kv,
                                      self._btl_fn(ns, coll))
        if len(batch):
            self._apply_state_updates(batch, num)
        # purge every txid the block carried (valid or not: an
        # invalidated private tx would otherwise keep its plaintext in
        # the transient store), and endorsement leftovers older than
        # the retention window (reference: PurgeBelowHeight)
        self._transient.purge_by_txids([txid for txid, _r, _f in txs if txid])
        self._transient.purge_below_height(
            max(0, num - self.TRANSIENT_RETENTION_BLOCKS))
        # BTL expiry: delete a key only while its committed version IS
        # the expiring write; a later rewrite has its own window
        purge_batch = UpdateBatch()
        for bn, tn, ns, coll, keys in self._pvtstore.expiring_at(num):
            pns = pvt_namespace(ns, coll)
            for key in keys:
                if self.state.get_version(pns, key) == (bn, tn):
                    purge_batch.delete(pns, key, (num, 0))
        if len(purge_batch):
            self._apply_state_updates(purge_batch, num)
        self._pvtstore.purge(num)
        # one durability barrier for the whole block's private data
        self._pvtstore.sync()

    # -- reconciliation (reference: gossip/privdata/reconcile.go:339) ----
    def get_pvt(self, block_num: int, tx_num: int):
        """Committed plaintext private write sets of one tx:
        [(ns, collection, KVRWSet)] — what reconciliation serves."""
        if self._pvtstore is None:
            return []
        return self._pvtstore.get(block_num, tx_num)

    def missing_pvt_count(self) -> int:
        """The whole reconciliation backlog."""
        if self._pvtstore is None:
            return 0
        return self._pvtstore.missing_count()

    def missing_pvt(self, limit: int = 50):
        """Unreconciled (block, tx, ns, collection) digests, dropping
        any whose BTL already lapsed."""
        if self._pvtstore is None:
            return []
        out = []
        for bn, tn, ns, coll in self._pvtstore.missing(limit):
            if self._pvt_expired(bn, ns, coll):
                self._pvtstore.drop_missing(bn, tn, ns, coll)
                continue
            out.append((bn, tn, ns, coll))
        return out

    def _pvt_expired(self, block_num: int, ns: str, coll: str) -> bool:
        """The BTL lapse, aligned with the purge schedule: data from
        `block_num` is purged while block block_num+btl+1 commits, so
        it is dead once height >= block_num+btl+2."""
        btl = self._btl_fn(ns, coll)
        return btl > 0 and block_num + btl + 2 <= self.height

    def reconcile_pvt(self, block_num: int, tx_num: int, ns: str,
                      coll: str, kv: m.KVRWSet) -> bool:
        """Backfill a missing private write set obtained from a peer:
        check it against the hashes the committed block carries, then
        apply its writes at the state's savepoint, skipping keys a
        later tx wrote or deleted.  True when the digest was
        resolved."""
        with self._lock:
            if self._pvtstore is None or \
                    not self._pvtstore.is_missing(block_num, tx_num, ns, coll):
                return False
            if self._pvt_expired(block_num, ns, coll):
                self._pvtstore.drop_missing(block_num, tx_num, ns, coll)
                return False               # expired while missing
            block = self.blockstore.get_block_by_number(block_num)
            if block is None:
                return False
            flags = protoutil.block_txflags(block)
            envs = protoutil.get_envelopes(block)
            if tx_num >= len(envs) or \
                    flags[tx_num] != m.TxValidationCode.VALID:
                self._pvtstore.drop_missing(block_num, tx_num, ns, coll)
                return False
            rwset = tx_rwset_from_envelope(envs[tx_num])
            hset = None
            if rwset is not None:
                for ns_entry in rwset.ns_rwset:
                    if ns_entry.namespace != ns:
                        continue
                    for ch in ns_entry.collection_hashed_rwset:
                        if ch.collection_name == coll:
                            hset = m.HashedRWSet.decode(ch.hashed_rwset)
            if hset is None:
                self._pvtstore.drop_missing(block_num, tx_num, ns, coll)
                return False               # the block never hashed it
            try:
                verify_pvt_against_hashes(hset, kv)
            except PvtDataMismatchError:
                return False               # forged response; keep waiting
            batch = UpdateBatch()
            pns = pvt_namespace(ns, coll)
            later_keys = self._pvtstore.later_written_keys(
                block_num, tx_num, ns, coll)
            for w in kv.writes:
                cur = self.state.get_version(pns, w.key)
                if cur is not None and cur >= (block_num, tx_num):
                    continue               # a later tx already wrote it
                if w.key in later_keys:
                    continue               # a later delete left no version
                if w.is_delete:
                    batch.delete(pns, w.key, (block_num, tx_num))
                else:
                    batch.put(pns, w.key, w.value, (block_num, tx_num))
            if len(batch):
                # the savepoint stays where it is: this backfills an old
                # block, it does not advance commit progress
                self._apply_state_updates(batch, self.state.savepoint)
            self._pvtstore.commit(block_num, tx_num, ns, coll, kv,
                                  self._btl_fn(ns, coll))
            return True

    # -- state fingerprint -----------------------------------------------
    def _fp_scan_acc(self) -> int:
        acc = 0
        for ns, key, value, ver in self.state.iter_state():
            acc ^= _fp_row(ns, key, value, ver)
        for ns, key, entries in self.state.iter_metadata():
            acc ^= _fp_meta(ns, key, entries)
        return acc

    def _fp_fold(self, batch: UpdateBatch) -> None:
        """Fold one UpdateBatch into the accumulator: the exact delta
        the state's apply_updates is about to make (a put keeps the
        row's metadata, a delete drops it, a metadata write bumps the
        row's version and skips a row absent after the value pass).
        Called BEFORE the apply, while the old entries are readable."""
        acc = self._fp_acc
        state = self.state
        for (ns, key), (value, version) in batch.updates.items():
            old = state.get_state(ns, key)
            if old is not None:
                acc ^= _fp_row(ns, key, old[0], old[1])
                if value is None:
                    oldm = state.get_metadata(ns, key)
                    if oldm:
                        acc ^= _fp_meta(ns, key, oldm)
            if value is not None:
                acc ^= _fp_row(ns, key, value, version)
        for (ns, key), (entries, version) in batch.meta_updates.items():
            upd = batch.updates.get((ns, key))
            if upd is not None:
                value, ver = upd
                if value is None:
                    continue          # row gone after the value pass
            else:
                got = state.get_state(ns, key)
                if got is None:
                    continue          # metadata without a key: no-op
                value, ver = got
            acc ^= _fp_row(ns, key, value, ver)
            acc ^= _fp_row(ns, key, value, version)
            oldm = state.get_metadata(ns, key)
            if oldm:
                acc ^= _fp_meta(ns, key, oldm)
            if entries:
                acc ^= _fp_meta(ns, key, dict(entries))
        self._fp_acc = acc

    def _apply_state_updates(self, batch: UpdateBatch, height: int) -> None:
        """Every state change goes through here, so the fingerprint
        accumulator cannot drift from the state it summarizes."""
        if self._fp_acc is not None and len(batch):
            self._fp_fold(batch)
        self.state.apply_updates(batch, height)

    def state_fingerprint(self) -> str:
        """Digest of the entire committed state — every (ns, key,
        value, version) row, every key-metadata entry, and the chain
        height — equal to the reference ledger's for the same blocks
        and flags.  The first call scans to seed the accumulator; later
        calls are O(1).  Taken under the commit lock: a commit advances
        the block store before it applies the state."""
        with tracing.span("fingerprint", channel=self.ledger_id):
            with self._lock:
                if self._fp_acc is None:
                    self._fp_acc = self._fp_scan_acc()
                h = hashlib.sha256(self.height.to_bytes(8, "big"))
                h.update(self._fp_acc.to_bytes(32, "big"))
                return h.hexdigest()

    def state_fingerprint_full(self) -> str:
        """The fingerprint rescanned from scratch, bypassing the
        accumulator: the incremental path's oracle."""
        with self._lock:
            h = hashlib.sha256(self.height.to_bytes(8, "big"))
            h.update(self._fp_scan_acc().to_bytes(32, "big"))
            return h.hexdigest()

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
        if block is None:
            return None                    # a known txid, a missing block
        flags = protoutil.block_txflags(block)
        return m.ProcessedTransaction(
            transaction_envelope=protoutil.get_envelopes(block)[loc[1]],
            validation_code=flags[loc[1]])

    def tx_id_exists(self, txid: str) -> bool:
        return self.blockstore.get_tx_loc(txid) is not None

    def snapshot_to(self, out_dir: str) -> dict:
        """Export a snapshot (ledger/snapshot.py `generate_snapshot`)
        under the commit lock, so no block lands while the state it
        seals is being read."""
        with self._lock:
            return generate_snapshot(self, out_dir)

    def close(self) -> None:
        """Checkpoint and close the stores (the attached private-data
        stores too), then the block store; a temporary directory is
        removed."""
        with self._lock:
            if self._durable:
                self.state.close()
                self.history.close()
            else:
                self.state.snapshot(self._state_path)
            self.confighistory.close()
            for store in (self._transient, self._pvtstore):
                if store is not None:
                    store.close()
            self.blockstore.close()
            if self._tmp is not None:
                self._tmp.cleanup()


class LedgerManager:
    """Open/create durable ledgers by id under one directory
    (reference: ledgermgmt/ledger_mgmt.go)."""

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
        if os.path.isdir(self.root):
            existing.update(os.listdir(self.root))
        return sorted(existing)

    def close(self) -> None:
        for led in self._ledgers.values():
            led.close()
