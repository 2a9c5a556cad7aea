"""The port's MVCC pass and state DB against the JAX reference's: the same
seeded read-write sets (stale and fresh reads, reads of keys written
earlier in the block, range queries with and without phantoms, deletes,
metadata writes, upstream-invalid and undecodable txs) over the same
prefilled state give the same flags, the same UpdateBatch and the same
state after it is applied."""
import random

import pytest

from fabric_mod_tpu.ledger import mvcc as jmvcc
from fabric_mod_tpu.ledger import rwsetutil as jrw
from fabric_mod_tpu.ledger import statedb as jsdb
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch.ledger import mvcc, rwsetutil, statedb
from fabric_mod_tpu_torch.protos import messages as m

NS = ("mycc", "other")
KEYS = [f"k{i:02d}" for i in range(30)]


def _prefill(seed):
    """(port db, reference db, {(ns, key): version}) with the same rows
    and metadata."""
    rng = random.Random(seed)
    batch, jbatch, vers = statedb.UpdateBatch(), jsdb.UpdateBatch(), {}
    for ns in NS:
        for key in KEYS:
            if rng.random() < 0.7:
                ver = (rng.randrange(5), rng.randrange(50))
                val = rng.randbytes(rng.randrange(1, 12))
                batch.put(ns, key, val, ver)
                jbatch.put(ns, key, val, ver)
                vers[(ns, key)] = ver
                if rng.random() < 0.2:
                    meta = {"VALIDATION_PARAMETER": rng.randbytes(6)}
                    batch.put_metadata(ns, key, meta, ver)
                    jbatch.put_metadata(ns, key, meta, ver)
    db, jdb = statedb.VersionedDB(), jsdb.VersionedDB()
    db.apply_updates(batch, 4)
    jdb.apply_updates(jbatch, 4)
    return db, jdb, vers


def _rwsets(seed, db, vers, n_tx=60):
    """Per tx: (port rwset | None, reference rwset | None, flag in)."""
    rng = random.Random(seed + 1)
    out = []
    for _ in range(n_tx):
        if rng.random() < 0.05:
            out.append((None, None, jm.TxValidationCode.VALID))
            continue
        flag = (jm.TxValidationCode.VALID if rng.random() < 0.85
                else jm.TxValidationCode.ENDORSEMENT_POLICY_FAILURE)
        b, jb = rwsetutil.RWSetBuilder(), jrw.RWSetBuilder()

        def both(method, *a):
            getattr(b, method)(*a)
            getattr(jb, method)(*a)
        for _ in range(rng.randrange(0, 4)):
            ns, key = rng.choice(NS), rng.choice(KEYS)
            ver = vers.get((ns, key))
            r = rng.random()
            if r < 0.15:
                ver = (9, rng.randrange(9))               # stale
            elif r < 0.25:
                ver = None                                # "absent"
            both("add_read", ns, key, ver)
        if rng.random() < 0.4:
            ns = rng.choice(NS)
            lo, hi = sorted(rng.sample(range(len(KEYS) + 1), 2))
            start, end = KEYS[lo], KEYS[hi] if hi < len(KEYS) else ""
            rows = [(k, v) for k, _val, v in db.get_state_range(ns, start, end)]
            if rng.random() < 0.2:
                rows = rows[1:]                           # a phantom
            both("add_range_query", ns, start, end, True, rows)
        for _ in range(rng.randrange(0, 3)):
            ns, key = rng.choice(NS), rng.choice(KEYS)
            both("add_write", ns, key,
                 None if rng.random() < 0.2 else rng.randbytes(4))
        if rng.random() < 0.25:
            ns, key = rng.choice(NS), rng.choice(KEYS)
            both("add_metadata_write", ns, key, "VALIDATION_PARAMETER",
                 rng.randbytes(3))
        raw = b.build().encode()
        assert raw == jb.build().encode()
        out.append((m.TxReadWriteSet.decode(raw),
                    jm.TxReadWriteSet.decode(raw), flag))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_mvcc_flags_batch_and_state_equal(seed):
    db, jdb, vers = _prefill(seed)
    txs = _rwsets(seed, db, vers)
    flags, batch, writes = mvcc.validate_and_prepare_batch(
        [(f"t{i}", rw, f) for i, (rw, _j, f) in enumerate(txs)], db, 5)
    jflags, jbatch, jwrites = jmvcc.validate_and_prepare_batch(
        [(f"t{i}", jrwset, f) for i, (_p, jrwset, f) in enumerate(txs)],
        jdb, 5)
    assert flags == jflags
    assert batch.updates == jbatch.updates
    assert batch.meta_updates == jbatch.meta_updates
    assert writes == jwrites
    codes = set(flags)
    V = jm.TxValidationCode
    # the seeds reach every outcome the pass can give
    assert {V.VALID, V.MVCC_READ_CONFLICT, V.BAD_RWSET,
            V.ENDORSEMENT_POLICY_FAILURE} <= codes, codes
    db.apply_updates(batch, 5)
    jdb.apply_updates(jbatch, 5)
    assert list(db.iter_state()) == list(jdb.iter_state())
    assert list(db.iter_metadata()) == list(jdb.iter_metadata())


def test_phantom_and_range_outcomes_present():
    """Across the seeds, range queries both pass and fail."""
    seen = set()
    for seed in range(1, 5):
        db, jdb, vers = _prefill(seed)
        txs = _rwsets(seed, db, vers)
        flags, _b, _w = mvcc.validate_and_prepare_batch(
            [(f"t{i}", rw, f) for i, (rw, _j, f) in enumerate(txs)], db, 5)
        seen.update(flags)
    assert jm.TxValidationCode.PHANTOM_READ_CONFLICT in seen
    assert rwsetutil.range_fingerprint([("a", (1, 2))]) == \
        jrw.range_fingerprint([("a", (1, 2))])
