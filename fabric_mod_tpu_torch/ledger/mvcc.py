"""MVCC validation: serial read-set version checks + phantom detection.

The port's copy of fabric_mod_tpu/ledger/mvcc.py's generic
`validate_and_prepare_batch` (reference: core/ledger/kvledger/txmgmt/
validation/validator.go:82 `validateAndPrepareBatch`, `validateKVRead`
at :173, range-query
re-execution for phantom reads.)  Runs after signature/policy
validation (which the device batch already decided); this stage is
inherently serial because each transaction's reads must be checked
against the writes of every earlier valid transaction in the same
block — the reference keeps it on one goroutine, we keep it on host.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from fabric_mod_tpu_torch.ledger.rwsetutil import (
    parse_tx_rwset, range_fingerprint, version_tuple)
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch, VersionedDB
from fabric_mod_tpu_torch.protos import messages as m

Version = Tuple[int, int]


def _read_conflicts(db: VersionedDB, batch: UpdateBatch,
                    ns: str, read: m.KVRead) -> bool:
    """A read conflicts if the key was touched earlier in this block —
    including deletes — or its committed version moved (reference:
    validator.go:173 validateKVRead: any key present in the update
    batch conflicts outright)."""
    if batch.get(ns, read.key) is not None:
        return True
    return db.get_version(ns, read.key) != version_tuple(read.version)


def _combined_range(db: VersionedDB, batch: UpdateBatch,
                    ns: str, start: str, end: str):
    """Merge committed state with the in-block pending batch, key order."""
    pending = {key: val for (n, key), val in batch.updates.items()
               if n == ns and start <= key and (not end or key < end)}
    out = []
    for key, value, ver in db.get_state_range(ns, start, end):
        if key in pending:
            continue                        # overridden by this block
        out.append((key, ver))
    for key, (value, ver) in pending.items():
        if value is not None:
            out.append((key, ver))
    out.sort(key=lambda kv: kv[0])
    return out


def validate_kv_read(db: VersionedDB, batch: UpdateBatch,
                     ns: str, read: m.KVRead) -> bool:
    return not _read_conflicts(db, batch, ns, read)


def validate_range_query(db: VersionedDB, batch: UpdateBatch, ns: str,
                         rq: m.RangeQueryInfo) -> bool:
    results = _combined_range(db, batch, ns, rq.start_key, rq.end_key)
    return range_fingerprint(results) == rq.reads_merkle_hash


def validate_and_prepare_batch(
        txs: List[Tuple[str, Optional[m.TxReadWriteSet], int]],
        db: VersionedDB, block_num: int
) -> Tuple[List[int], UpdateBatch, List[Tuple[int, str, str]]]:
    """Serial MVCC pass over a block.

    `txs` is [(tx_id, rwset | None, incoming_flag)] in block order;
    incoming flags carry upstream verdicts (signature/policy/dup) —
    only VALID transactions are MVCC-checked.  Returns the final
    per-tx validation codes, the state UpdateBatch of the surviving
    writes versioned (block_num, tx_num), and the per-tx write list
    [(tx_num, ns, key)] for the history DB (parsed once here so the
    commit path never re-decodes rwsets).
    """
    flags: List[int] = []
    batch = UpdateBatch()
    tx_writes: List[Tuple[int, str, str]] = []
    for tx_num, (txid, rwset, incoming) in enumerate(txs):
        if incoming != m.TxValidationCode.VALID:
            flags.append(incoming)
            continue
        if rwset is None:
            flags.append(m.TxValidationCode.BAD_RWSET)
            continue
        try:
            ns_sets = parse_tx_rwset(rwset)
        except Exception:
            flags.append(m.TxValidationCode.BAD_RWSET)
            continue
        verdict = m.TxValidationCode.VALID
        for ns, kv in ns_sets:
            for read in kv.reads:
                if not validate_kv_read(db, batch, ns, read):
                    verdict = m.TxValidationCode.MVCC_READ_CONFLICT
                    break
            if verdict != m.TxValidationCode.VALID:
                break
            for rq in kv.range_queries_info:
                if not validate_range_query(db, batch, ns, rq):
                    verdict = m.TxValidationCode.PHANTOM_READ_CONFLICT
                    break
            if verdict != m.TxValidationCode.VALID:
                break
        if verdict != m.TxValidationCode.VALID:
            flags.append(verdict)
            continue
        for ns, kv in ns_sets:
            for w in kv.writes:
                if w.is_delete:
                    batch.delete(ns, w.key, (block_num, tx_num))
                else:
                    batch.put(ns, w.key, w.value, (block_num, tx_num))
                tx_writes.append((tx_num, ns, w.key))
            for mw in kv.metadata_writes:
                batch.put_metadata(
                    ns, mw.key,
                    {e.name: e.value for e in mw.entries},
                    (block_num, tx_num))
        flags.append(m.TxValidationCode.VALID)
    return flags, batch, tx_writes
