"""The port's durable stores against the reference's (the port's
ledger/durable.py, statedb snapshots and confighistory.py against
fabric_mod_tpu/ledger's): the same seeded update batches give equal
states, versions, ranges, metadata and key histories, through reopen,
a torn tail, compaction and a checkpoint that bounds replay; a store
directory written by either package opens in the other with the same
contents (mirrors tests/test_durable.py)."""
import os
import struct

import numpy as np
import pytest

from fabric_mod_tpu.ledger import confighistory as jconfighistory
from fabric_mod_tpu.ledger import durable as jdurable
from fabric_mod_tpu.ledger import statedb as jstatedb

from fabric_mod_tpu_torch.ledger import confighistory, durable, statedb
from fabric_mod_tpu_torch.protos import messages as m

NS = ("cc", "cc$$pcol1", "_lifecycle")


def _batches(seed, n_blocks, per_block=12, n_keys=40):
    """Seeded (ns, key, value|None, version) puts and deletes, and
    metadata writes, a block each: [(puts, metas)]."""
    rng = np.random.RandomState(seed)
    out = []
    for blk in range(n_blocks):
        puts, metas = [], []
        for tx in range(per_block):
            ns = NS[rng.randint(len(NS))]
            key = "k%03d" % rng.randint(n_keys)
            value = None if rng.rand() < 0.2 else \
                rng.bytes(rng.randint(0, 64))
            puts.append((ns, key, value, (blk, tx)))
            if rng.rand() < 0.15:
                entries = {} if rng.rand() < 0.3 else \
                    {"VALIDATION_PARAMETER": rng.bytes(8)}
                metas.append((ns, "k%03d" % rng.randint(n_keys), entries,
                              (blk, tx)))
        out.append((puts, metas))
    return out


def _batch(mod, puts, metas):
    b = mod.UpdateBatch()
    for ns, key, value, ver in puts:
        if value is None:
            b.delete(ns, key, ver)
        else:
            b.put(ns, key, value, ver)
    for ns, key, entries, ver in metas:
        b.put_metadata(ns, key, entries, ver)
    return b


def _contents(db):
    rows = [(ns, k, bytes(v), tuple(ver)) for ns, k, v, ver in db.iter_state()]
    meta = [(ns, k, dict(e)) for ns, k, e in db.iter_metadata()]
    ranges = [[(k, bytes(v), tuple(ver))
               for k, v, ver in db.get_state_range(ns, "k010", "k030")]
              for ns in NS]
    return db.savepoint, rows, meta, ranges


def _apply_both(port, ref, batches, start=0):
    for blk, (puts, metas) in enumerate(batches, start):
        port.apply_updates(_batch(statedb, puts, metas), blk)
        ref.apply_updates(_batch(jstatedb, puts, metas), blk)


def test_state_batches_equal_reference(tmp_path):
    port = durable.DurableStateDB(str(tmp_path / "p"))
    ref = jdurable.DurableStateDB(str(tmp_path / "r"))
    batches = _batches(1, 20)
    _apply_both(port, ref, batches)
    assert _contents(port) == _contents(ref)
    pairs = [(ns, "k%03d" % i) for ns in NS for i in range(45)]
    assert port.get_versions_many(pairs) == ref.get_versions_many(pairs)
    for ns, key in pairs:
        assert port.get_state(ns, key) == ref.get_state(ns, key)
        assert port.get_metadata(ns, key) == ref.get_metadata(ns, key)
    # one buffered write a block, its frames: every record + the savepoint
    assert port.batch_writes == 20
    assert port.batch_frames == sum(
        len({(ns, k) for ns, k, _v, _ver in puts})
        + len({(ns, k) for ns, k, _e, _ver in metas}) + 1
        for puts, metas in batches)
    port.close()
    ref.close()
    # the logs and checkpoints are byte for byte the reference's
    for name in sorted(os.listdir(tmp_path / "p")):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes(), name


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_state_directory_opens_in_the_other_package(tmp_path, writer):
    mods = {"port": durable, "reference": jdurable}
    sts = {"port": statedb, "reference": jstatedb}
    other = "reference" if writer == "port" else "port"
    d = str(tmp_path / "s")
    db = mods[writer].DurableStateDB(d)
    for blk, (puts, metas) in enumerate(_batches(2, 12)):
        db.apply_updates(_batch(sts[writer], puts, metas), blk)
    want = _contents(db)
    db.close()
    opened = mods[other].DurableStateDB(d)
    assert _contents(opened) == want
    # and it goes on from there in step with the writer's package
    more = _batches(3, 4)
    for blk, (puts, metas) in enumerate(more, 12):
        opened.apply_updates(_batch(sts[other], puts, metas), blk)
    opened.close()
    again = mods[writer].DurableStateDB(d)
    ref = jdurable.DurableStateDB(str(tmp_path / "fresh"))
    for blk, (puts, metas) in enumerate(_batches(2, 12) + more):
        ref.apply_updates(_batch(jstatedb, puts, metas), blk)
    assert _contents(again) == _contents(ref)
    again.close()
    ref.close()


def test_state_reopen_and_torn_tail(tmp_path):
    port = durable.DurableStateDB(str(tmp_path / "p"))
    ref = jdurable.DurableStateDB(str(tmp_path / "r"))
    _apply_both(port, ref, _batches(4, 6))
    for db in (port, ref):                 # crash: no close checkpoint
        path = db._store._path("log", db._gen)
        db._f.close()
        db._fr.close()
        with open(path, "r+b") as f:       # cut inside the last record
            f.truncate(os.path.getsize(path) - 5)
    port2 = durable.DurableStateDB(str(tmp_path / "p"))
    ref2 = jdurable.DurableStateDB(str(tmp_path / "r"))
    assert port2.savepoint == ref2.savepoint == 4
    assert _contents(port2) == _contents(ref2)
    assert os.path.getsize(port2._store._path("log", port2._gen)) == \
        port2._log_size
    port2.close()
    ref2.close()


def test_state_compaction_equals_reference(tmp_path):
    port = durable.DurableStateDB(str(tmp_path / "p"))
    ref = jdurable.DurableStateDB(str(tmp_path / "r"))
    for db in (port, ref):
        db.COMPACT_MIN_BYTES = 2048
    val = b"x" * 200
    for blk in range(30):
        for db, mod in ((port, statedb), (ref, jstatedb)):
            b = mod.UpdateBatch()
            b.put("cc", "hot", val + b"%d" % blk, (blk, 0))
            b.put("cc", "cold%d" % (blk % 3), b"c", (blk, 1))
            if blk == 5:
                b.put_metadata("cc", "hot", {"VP": b"p"}, (blk, 2))
            db.apply_updates(b, blk)
    assert port._gen == ref._gen > 0
    assert _contents(port) == _contents(ref)
    port.close()
    ref.close()
    port2 = durable.DurableStateDB(str(tmp_path / "p"))
    assert port2.get_state("cc", "hot")[0].endswith(b"29")
    assert port2.get_metadata("cc", "hot") == {"VP": b"p"}
    assert port2.savepoint == 29
    port2.close()


def test_state_checkpoint_bounds_replay(tmp_path):
    d = str(tmp_path / "s")
    db = durable.DurableStateDB(d)
    db.CKPT_EVERY = 10
    for blk in range(25):
        b = statedb.UpdateBatch()
        b.put("cc", "k%d" % blk, b"v", (blk, 0))
        db.apply_updates(b, blk)
    db._f.close()
    db._fr.close()                         # crash: no close checkpoint
    ck = db._store.read_checkpoint(db._gen)
    assert struct.unpack_from("<q", ck, 0)[0] == 19
    watermark = struct.unpack_from("<q", ck, 8)[0]
    assert 0 < watermark < os.path.getsize(db._store._path("log", db._gen))
    db2 = durable.DurableStateDB(d)
    assert db2.savepoint == 24 and len(db2._keydir) == 25
    ref = jdurable.DurableStateDB(d)       # the reference reads it too
    assert _contents(ref) == _contents(db2)
    db2.close()
    ref.close()


def test_history_equals_reference_and_crosses(tmp_path):
    port = durable.DurableHistoryDB(str(tmp_path / "p"))
    ref = jdurable.DurableHistoryDB(str(tmp_path / "r"))
    rng = np.random.RandomState(5)
    for blk in range(12):
        writes = [(int(tx), NS[rng.randint(3)], "k%d" % rng.randint(9))
                  for tx in range(rng.randint(1, 6))]
        port.commit(blk, writes)
        ref.commit(blk, writes)
    port.commit(3, [(0, "cc", "k1")])      # a replayed block: skipped
    keys = [(ns, "k%d" % i) for ns in NS for i in range(9)]
    assert [port.get_history_for_key(*k) for k in keys] == \
        [ref.get_history_for_key(*k) for k in keys]
    want = [ref.get_history_for_key(*k) for k in keys]
    port._f.close()                        # crash: the port's log alone
    ref.close()
    assert [jdurable.DurableHistoryDB(str(tmp_path / "p"))
            .get_history_for_key(*k) for k in keys] == want
    crossed = durable.DurableHistoryDB(str(tmp_path / "r"))
    assert crossed.savepoint == 11
    assert [crossed.get_history_for_key(*k) for k in keys] == want
    crossed.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshot_crosses_packages(tmp_path, writer):
    sts = {"port": statedb, "reference": jstatedb}
    other = "reference" if writer == "port" else "port"
    db = sts[writer].VersionedDB()
    for blk, (puts, metas) in enumerate(_batches(6, 8)):
        db.apply_updates(_batch(sts[writer], puts, metas), blk)
    path = str(tmp_path / "state.snap")
    db.snapshot(path)
    loaded = sts[other].VersionedDB.load(path)
    assert _contents(loaded) == _contents(db)
    # a torn snapshot loads empty in both (the ledger replays blocks)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 1)
    assert statedb.VersionedDB.load(path).savepoint == \
        jstatedb.VersionedDB.load(path).savepoint == -1


def _definition(collections: bytes, mod):
    return mod.ChaincodeDefinition(version="1.0", sequence=1,
                                   collections=collections).encode()


def test_config_history_equals_reference_and_crosses(tmp_path):
    pkg = m.CollectionConfigPackage(config=[m.CollectionConfig(
        static_collection_config=m.StaticCollectionConfig(
            name="col1", block_to_live=3))]).encode()
    writes = {
        2: [("_lifecycle", "namespaces/mycc", _definition(pkg, m))],
        5: [("_lifecycle", "namespaces/mycc", _definition(b"", m)),
            ("_lifecycle", "namespaces/mycc/approval", b"x"),
            ("cc", "namespaces/other", _definition(pkg, m))],
        7: [("_lifecycle", "namespaces/bad", b"\xff\xff")],
    }
    p = confighistory.ConfigHistoryManager(str(tmp_path / "p.jsonl"))
    r = jconfighistory.ConfigHistoryManager(str(tmp_path / "r.jsonl"))
    for blk in range(10):
        p.handle_block_writes(blk, writes.get(blk, []))
        r.handle_block_writes(blk, writes.get(blk, []))
    for blk in range(10):
        got = p.most_recent_collection_config_below("mycc", blk)
        want = r.most_recent_collection_config_below("mycc", blk)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[0] == want[0]
            assert got[1].encode() == want[1].encode()
    assert p.collection_config_history("mycc") == \
        r.collection_config_history("mycc")
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "r.jsonl").read_bytes()
    p.close()
    # a clean close persists the port's savepoint (the reference's lags
    # at its last record); the reference reads it
    assert jconfighistory.ConfigHistoryManager(
        str(tmp_path / "p.jsonl")).savepoint == 9
    assert r.savepoint == 9
    # each package reads either file with a torn record: cropped, and the
    # savepoint falls back to the last intact record
    for path in ("p.jsonl", "r.jsonl"):
        for mod in (confighistory, jconfighistory):
            d = tmp_path / f"{path}-{mod.__name__}"
            d.mkdir()
            for suffix in ("", ".sp"):
                (d / ("h.jsonl" + suffix)).write_bytes(
                    (tmp_path / (path + suffix)).read_bytes())
            with open(d / "h.jsonl", "ab") as f:
                f.write(b'{"ns": "my')
            h = mod.ConfigHistoryManager(str(d / "h.jsonl"))
            assert h.collection_config_history("mycc") == \
                r.collection_config_history("mycc")
            assert h.savepoint == 5
            assert (d / "h.jsonl").read_bytes() == \
                (tmp_path / "r.jsonl").read_bytes()
