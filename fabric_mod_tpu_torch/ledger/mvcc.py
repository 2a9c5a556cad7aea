"""MVCC validation: serial read-set version checks + phantom detection.

The port's copy of fabric_mod_tpu/ledger/mvcc.py: the generic
`validate_and_prepare_batch` and its vectorized twin over the columnar
planes of protos/batchdecode.py, `validate_and_prepare_batch_vectorized`
(reference :148), which give the same flags, update batch and tx
writes (reference: core/ledger/kvledger/txmgmt/
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

import numpy as np

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.ledger.rwsetutil import (
    parse_tx_rwset, range_fingerprint, version_tuple)
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch, VersionedDB
from fabric_mod_tpu_torch.observability import tracing
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


# ---------------------------------------------------------------------------
# Vectorized MVCC (reference :140-414): the serial per-key probes above
# replaced by one bulk get_versions_many call (a hash-join over the block's
# columnar key plane) and numpy version compares.  The per-tx loop stays —
# MVCC is serial in the in-block write dependency — but its body collapses
# to slice reductions over precomputed conflict masks.  Rows the batch
# scanner could not prove (fallback txs) are parsed generically and merged
# into the same planes, so the two paths share one verdict engine and the
# (flags, batch, tx_writes) triple equals validate_and_prepare_batch's by
# the same check order: per ns occurrence, reads (first conflict ->
# MVCC_READ_CONFLICT) then range re-execution (-> PHANTOM_READ_CONFLICT).
# ---------------------------------------------------------------------------

# sentinel rwset marker: this tx's rows live in the columnar planes
COLUMNAR = object()


def validate_and_prepare_batch_vectorized(
        txs, db, block_num: int, planes
) -> Tuple[List[int], UpdateBatch, List[Tuple[int, str, str]]]:
    """Vectorized twin of :func:`validate_and_prepare_batch`.

    `txs` as the generic pass, except a tx whose rwset is the
    :data:`COLUMNAR` sentinel reads its rows from `planes` (a
    batchdecode.BlockRWSets); any other rwset (fallback rows,
    non-endorser empties) is parsed generically and merged.  One
    `db.get_versions_many` call resolves every committed version the
    block touches; read conflicts become numpy compares against that
    join plus a `touched` bitmap standing in for `batch.get`.  Timed
    as the "mvcc_vector" span (reference :170).
    """
    faults.point("peer.mvcc.vector")
    with tracing.span("mvcc_vector", block=block_num, txs=len(txs)):
        return _validate_vectorized(txs, db, block_num, planes)


def _validate_vectorized(txs, db, block_num: int, planes):
    n = len(txs)
    VALID = m.TxValidationCode.VALID

    # -- gather rows: columnar planes + generically-parsed extras --
    col = np.zeros(n, bool)
    bad_rwset = [False] * n
    g_rtx, g_rnsi, g_rns, g_rkey, g_rver = [], [], [], [], []
    g_wtx, g_wns, g_wkey, g_wdel, g_wval = [], [], [], [], []
    g_qtx, g_qnsi, g_qns, g_qrqi = [], [], [], []
    g_mtx, g_mns, g_mkey, g_ment = [], [], [], []
    for tx_num, (txid, rwset, incoming) in enumerate(txs):
        if incoming != VALID:
            # planes may carry rows for upstream-invalid txs; the
            # per-tx loop below never consumes them
            col[tx_num] = rwset is COLUMNAR
            continue
        if rwset is COLUMNAR:
            col[tx_num] = True
            continue
        if rwset is None:
            bad_rwset[tx_num] = True
            continue
        try:
            ns_sets = parse_tx_rwset(rwset)
        except Exception:
            bad_rwset[tx_num] = True
            continue
        for nsi, (ns, kv) in enumerate(ns_sets):
            for read in kv.reads:
                g_rtx.append(tx_num)
                g_rnsi.append(nsi)
                g_rns.append(ns)
                g_rkey.append(read.key)
                g_rver.append(version_tuple(read.version))
            for rq in kv.range_queries_info:
                g_qtx.append(tx_num)
                g_qnsi.append(nsi)
                g_qns.append(ns)
                g_qrqi.append(rq)
            for w in kv.writes:
                g_wtx.append(tx_num)
                g_wns.append(ns)
                g_wkey.append(w.key)
                g_wdel.append(bool(w.is_delete))
                g_wval.append(w.value)
            for mw in kv.metadata_writes:
                g_mtx.append(tx_num)
                g_mns.append(ns)
                g_mkey.append(mw.key)
                g_ment.append({e.name: e.value for e in mw.entries})

    # -- plane row filter: only sentinel-marked txs' rows ----------
    # a caller may route an accepted-body tx generically; its plane
    # rows must not double-count
    def _filter(tx_arr, arrs, lists):
        tx_arr = np.asarray(tx_arr, np.int64)
        if tx_arr.size == 0:
            return tx_arr, arrs, lists
        keep = col[tx_arr]
        if keep.all():
            return tx_arr, arrs, lists
        kl = keep.tolist()
        return (tx_arr[keep],
                [np.asarray(a)[keep] for a in arrs],
                [[v for v, k in zip(lst, kl) if k]
                 for lst in lists])

    if planes is not None:
        pr_tx, (pr_nsi, pr_has, pr_vb, pr_vt), (pr_ns, pr_key) = \
            _filter(planes.read_tx,
                    [planes.read_nsi, planes.read_has_ver,
                     planes.read_vb, planes.read_vt],
                    [planes.read_ns, planes.read_key])
        pw_tx, _, (pw_ns, pw_key, pw_del, pw_val) = _filter(
            planes.write_tx, [],
            [planes.write_ns, planes.write_key,
             planes.write_del, planes.write_val])
        pq_tx, (pq_nsi,), (pq_ns, pq_rqi) = _filter(
            planes.range_tx, [planes.range_nsi],
            [planes.range_ns, planes.range_rqi])
        pm_tx, _, (pm_ns, pm_key, pm_ent) = _filter(
            planes.meta_tx, [],
            [planes.meta_ns, planes.meta_key, planes.meta_entries])
    else:
        e = np.zeros(0, np.int64)
        pr_tx = pw_tx = pq_tx = pm_tx = e
        pr_nsi = pq_nsi = pr_vb = pr_vt = e
        pr_has = np.zeros(0, bool)
        pr_ns = pr_key = pw_ns = pw_key = pw_del = pw_val = []
        pq_ns = pq_rqi = pm_ns = pm_key = pm_ent = []

    # -- hash-join every (ns, key) the block touches ---------------
    key_ids: dict = {}

    def kid(ns, key):
        t = (ns, key)
        got = key_ids.get(t)
        if got is None:
            got = len(key_ids)
            key_ids[t] = got
        return got

    p_rkid = np.fromiter(
        (kid(ns, k) for ns, k in zip(pr_ns, pr_key)),
        np.int64, len(pr_key))
    p_wkid = np.fromiter(
        (kid(ns, k) for ns, k in zip(pw_ns, pw_key)),
        np.int64, len(pw_key))
    g_rkid = [kid(ns, k) for ns, k in zip(g_rns, g_rkey)]
    g_wkid = [kid(ns, k) for ns, k in zip(g_wns, g_wkey)]

    # ONE statedb interface call for the whole block
    committed = db.get_versions_many(list(key_ids.keys()))
    nk = len(committed)
    c_has = np.fromiter((v is not None for v in committed), bool, nk)
    c_vb = np.fromiter((v[0] if v is not None else 0
                        for v in committed), np.int64, nk)
    c_vt = np.fromiter((v[1] if v is not None else 0
                        for v in committed), np.int64, nk)

    # -- static (committed-version) conflict mask per read row -----
    # columnar rows: pure numpy compares against the join
    if p_rkid.size:
        pm_has = c_has[p_rkid]
        p_bad = (pm_has != pr_has) | (
            pm_has & pr_has
            & ((c_vb[p_rkid] != pr_vb) | (c_vt[p_rkid] != pr_vt)))
    else:
        p_bad = np.zeros(0, bool)
    # fallback rows: the generic formula verbatim (their versions
    # can exceed what the scanner's 9-byte varint cap admits)
    g_bad = [committed[k] != v for k, v in zip(g_rkid, g_rver)]

    # -- merge planes + extras into one tx-sorted row set ----------
    def merged(p_arr, g_list, dtype=np.int64):
        if not g_list:
            return np.asarray(p_arr, dtype)
        return np.concatenate(
            [np.asarray(p_arr, dtype), np.asarray(g_list, dtype)])

    def reorder_lists(p_list, g_list, order):
        joined = list(p_list) + g_list
        return [joined[i] for i in order]

    r_tx = merged(pr_tx, g_rtx)
    r_order = np.argsort(r_tx, kind="stable")
    r_tx = r_tx[r_order]
    r_nsi = merged(pr_nsi, g_rnsi)[r_order]
    r_kid = merged(p_rkid, g_rkid)[r_order]
    r_bad = merged(p_bad, g_bad, bool)[r_order]

    w_tx = merged(pw_tx, g_wtx)
    w_order = np.argsort(w_tx, kind="stable")
    w_olist = w_order.tolist()
    w_tx = w_tx[w_order]
    w_kid = merged(p_wkid, g_wkid)[w_order]
    w_ns = reorder_lists(pw_ns, g_wns, w_olist)
    w_key = reorder_lists(pw_key, g_wkey, w_olist)
    w_del = reorder_lists(pw_del, g_wdel, w_olist)
    w_val = reorder_lists(pw_val, g_wval, w_olist)

    q_tx = merged(pq_tx, g_qtx)
    q_order = np.argsort(q_tx, kind="stable")
    q_olist = q_order.tolist()
    q_tx = q_tx[q_order]
    q_nsi = merged(pq_nsi, g_qnsi)[q_order]
    q_ns = reorder_lists(pq_ns, g_qns, q_olist)
    q_rqi = reorder_lists(pq_rqi, g_qrqi, q_olist)

    mt_tx = merged(pm_tx, g_mtx)
    m_order = np.argsort(mt_tx, kind="stable")
    m_olist = m_order.tolist()
    mt_tx = mt_tx[m_order]
    mt_ns = reorder_lists(pm_ns, g_mns, m_olist)
    mt_key = reorder_lists(pm_key, g_mkey, m_olist)
    mt_ent = reorder_lists([dict(en) for en in pm_ent], g_ment,
                           m_olist)

    grid = np.arange(n + 1)
    rb = np.searchsorted(r_tx, grid)
    wb = np.searchsorted(w_tx, grid)
    qb = np.searchsorted(q_tx, grid)
    mb = np.searchsorted(mt_tx, grid)

    # -- the serial verdict loop over slice reductions -------------
    flags: List[int] = []
    batch = UpdateBatch()
    tx_writes: List[Tuple[int, str, str]] = []
    touched = np.zeros(max(nk, 1), bool)

    def walk(lo, hi, qlo, qhi):
        """Generic check order for a tx WITH range queries: per ns
        occurrence (nsi ascending), reads then ranges."""
        ri, qi = lo, qlo
        while ri < hi or qi < qhi:
            if qi >= qhi or (ri < hi and r_nsi[ri] <= q_nsi[qi]):
                nsi = r_nsi[ri]
                rj = ri
                while rj < hi and r_nsi[rj] == nsi:
                    rj += 1
                if r_bad[ri:rj].any() or touched[r_kid[ri:rj]].any():
                    return m.TxValidationCode.MVCC_READ_CONFLICT
                ri = rj
            else:
                nsi = q_nsi[qi]
            while qi < qhi and q_nsi[qi] == nsi:
                if not validate_range_query(db, batch, q_ns[qi],
                                            q_rqi[qi]):
                    return m.TxValidationCode.PHANTOM_READ_CONFLICT
                qi += 1
        return VALID

    for tx_num, (txid, rwset, incoming) in enumerate(txs):
        if incoming != VALID:
            flags.append(incoming)
            continue
        if bad_rwset[tx_num]:
            flags.append(m.TxValidationCode.BAD_RWSET)
            continue
        lo, hi = rb[tx_num], rb[tx_num + 1]
        qlo, qhi = qb[tx_num], qb[tx_num + 1]
        if qlo == qhi:
            verdict = VALID
            if lo < hi and (r_bad[lo:hi].any()
                            or touched[r_kid[lo:hi]].any()):
                verdict = m.TxValidationCode.MVCC_READ_CONFLICT
        else:
            verdict = walk(lo, hi, qlo, qhi)
        if verdict != VALID:
            flags.append(verdict)
            continue
        wlo, whi = wb[tx_num], wb[tx_num + 1]
        for idx in range(wlo, whi):
            ns, key = w_ns[idx], w_key[idx]
            if w_del[idx]:
                batch.delete(ns, key, (block_num, tx_num))
            else:
                batch.put(ns, key, w_val[idx], (block_num, tx_num))
            tx_writes.append((tx_num, ns, key))
        if wlo < whi:
            touched[w_kid[wlo:whi]] = True
        for idx in range(mb[tx_num], mb[tx_num + 1]):
            batch.put_metadata(mt_ns[idx], mt_key[idx],
                               mt_ent[idx], (block_num, tx_num))
        flags.append(VALID)
    return flags, batch, tx_writes
