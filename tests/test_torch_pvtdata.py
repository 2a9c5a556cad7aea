"""Private data in the port against the reference: the hash gate, the
transient and pvt stores' lifecycle, expiry bookkeeping and restart
(their directories open in either package); a private stream committed
into both packages' durable ledgers with the same transient contents
gives the same private state, missing digests, BTL purges,
reconciliation results and fingerprints; the has_pvt regression (a
pvt-bearing tx committed with stage-time rwsets while a transient store
is attached keeps its plaintext); and the e2e private round trip
through `Network.invoke(transient=)` (mirrors tests/test_pvtdata.py)."""
import tempfile

import pytest

from fabric_mod_tpu.ledger import pvtdata as jpvtdata
from fabric_mod_tpu.ledger.kvledger import KvLedger as JKvLedger
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger import pvtdata
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

V = m.TxValidationCode
NS, COL = fixtures.NAMESPACE, fixtures.PVT_COLLECTION
PNS = pvtdata.pvt_namespace(NS, COL)


def _pvt(mod, key, value, ns=NS, coll=COL):
    kv = mod.KVRWSet(writes=[mod.KVWrite(key=key, value=value)])
    return mod.TxPvtReadWriteSet(ns_pvt_rwset=[
        mod.NsPvtReadWriteSet(namespace=ns, collection_pvt_rwset=[
            mod.CollectionPvtReadWriteSet(collection_name=coll,
                                          rwset=kv.encode())])])


def test_hash_gate_and_builder_equal_reference():
    from fabric_mod_tpu.ledger.rwsetutil import RWSetBuilder as JRWSetBuilder
    for key, value in (("a", b"secret"), ("", b""), ("ké", b"\x00" * 9)):
        assert pvtdata.hash_key(key) == jpvtdata.hash_key(key)
        assert pvtdata.hash_value(value) == jpvtdata.hash_value(value)
    builders = (RWSetBuilder(), JRWSetBuilder())
    for b in builders:
        b.add_write(NS, "pub", b"1")
        b.add_pvt_write(NS, COL, "k1", b"v1")
        b.add_pvt_write(NS, COL, "k2", None)
        b.add_pvt_write(NS, "col2", "k", b"x")
        b.add_pvt_write("other", COL, "k", b"y")
    assert builders[0].build().encode() == builders[1].build().encode()
    assert builders[0].build_pvt().encode() == \
        builders[1].build_pvt().encode()
    assert RWSetBuilder().build_pvt() is None
    hset = m.HashedRWSet.decode(m.TxReadWriteSet.decode(
        builders[0].build().encode()).ns_rwset[0]
        .collection_hashed_rwset[0].hashed_rwset)
    kv = m.KVRWSet.decode(builders[0].build_pvt().ns_pvt_rwset[0]
                          .collection_pvt_rwset[0].rwset)
    pvtdata.verify_pvt_against_hashes(hset, kv)
    forged = m.KVRWSet(writes=[m.KVWrite(key="k1", value=b"FORGED"),
                               m.KVWrite(key="k2", is_delete=1)])
    with pytest.raises(pvtdata.PvtDataMismatchError):
        pvtdata.verify_pvt_against_hashes(hset, forged)
    with pytest.raises(jpvtdata.PvtDataMismatchError):
        jpvtdata.verify_pvt_against_hashes(
            jm.HashedRWSet.decode(hset.encode()),
            jm.KVRWSet.decode(forged.encode()))


@pytest.mark.parametrize("durable", [False, True])
def test_transient_store_lifecycle_and_restart(tmp_path, durable):
    d = str(tmp_path / "t") if durable else None
    ts = pvtdata.TransientStore(dir_path=d)
    ts.persist("tx1", 5, _pvt(m, "k1", b"v1"))
    ts.persist("tx1", 5, _pvt(m, "k1", b"v1"))     # N endorsers, one copy
    ts.persist("tx2", 9, _pvt(m, "k2", b"v2"))
    ts.persist("tx3", 9, _pvt(m, "k3", b"v3"))
    assert len(ts.get_by_txid("tx1")) == 1
    ts.purge_below_height(6)
    assert ts.get_by_txid("tx1") == []
    ts.purge_by_txids(["tx2"])
    assert ts.get_by_txid("tx2") == []
    assert ts.get_by_txid("tx3")[0].encode() == _pvt(m, "k3", b"v3").encode()
    if not durable:
        return
    # a crash (no close): each record was flushed; either package reopens
    for mod in (pvtdata, jpvtdata):
        again = mod.TransientStore(dir_path=d)
        assert again.get_by_txid("tx1") == again.get_by_txid("tx2") == []
        assert again.get_by_txid("tx3")[0].encode() == \
            _pvt(m, "k3", b"v3").encode()
        again.close()
    ts.close()
    small = pvtdata.TransientStore(max_entries=1)
    small.persist("a", 0, _pvt(m, "a", b"1"))
    small.persist("b", 0, _pvt(m, "b", b"2"))      # the flood guard drops it
    assert small.get_by_txid("b") == []


def test_pvt_store_bookkeeping_restart_and_crossing(tmp_path):
    d = str(tmp_path / "p")
    stores = (pvtdata.PvtDataStore(dir_path=d),
              jpvtdata.PvtDataStore(dir_path=str(tmp_path / "r")))
    for store, mod in zip(stores, (m, jm)):
        kv = mod.KVRWSet(writes=[mod.KVWrite(key="k", value=b"v")])
        store.commit(10, 0, NS, COL, kv, btl=3)
        store.commit(11, 2, NS, COL, kv, btl=0)
        store.report_missing(10, 1, NS, COL)
        store.report_missing(12, 0, NS, COL)
        store.drop_missing(12, 0, NS, COL)
        store.sync()
    port, ref = stores
    assert port.get(10, 0)[0][:2] == (NS, COL)
    assert port.expiring_at(14) == ref.expiring_at(14) == \
        [(10, 0, NS, COL, ["k"])]
    assert port.missing() == ref.missing() == [(10, 1, NS, COL)]
    assert port.later_written_keys(10, 0, NS, COL) == {"k"}
    port.purge(14)
    ref.purge(14)
    assert port.get(10, 0) == ref.get(10, 0) == []
    for a, b in ((d, d), (d, str(tmp_path / "r"))):
        for mod in (pvtdata, jpvtdata):
            again = mod.PvtDataStore(dir_path=b)
            assert again.missing() == [(10, 1, NS, COL)]
            assert again.get(10, 0) == []
            assert [(n, c, kv.encode()) for n, c, kv in again.get(11, 2)] == \
                [(NS, COL, m.KVRWSet(writes=[m.KVWrite(
                    key="k", value=b"v")]).encode())]
            again.close()
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def pvt_stream():
    world = fixtures.make_commit_world()
    blocks, plain, keys = fixtures.make_pvt_blocks(world, 2, 20,
                                                   pad_blocks=4, btl=2)
    return world, blocks, plain, keys


def test_private_stream_equals_reference(pvt_stream, tmp_path):
    """Both packages, durable, the same transient contents: Org1-style
    plaintext for half the private txs, a forged value for one, nothing
    for the rest.  Per block: flags, fingerprints (incremental == full),
    private rows, missing digests; then reconciliation of every missing
    digest (a forged answer first), the BTL purges of the padding
    blocks, and a restart of both."""
    world, blocks, plain, keys = pvt_stream
    txids = sorted(plain)
    have, forged = txids[::2], txids[1]
    btl = lambda ns, coll: 2                             # noqa: E731
    led = KvLedger(world.channel_id, str(tmp_path / "p"))
    led.attach_pvt(pvtdata.TransientStore(dir_path=str(tmp_path / "pt")),
                   pvtdata.PvtDataStore(dir_path=str(tmp_path / "pp")), btl)
    jled = JKvLedger(str(tmp_path / "r"), world.channel_id)
    jled.attach_pvt(jpvtdata.TransientStore(dir_path=str(tmp_path / "rt")),
                    jpvtdata.PvtDataStore(dir_path=str(tmp_path / "rp")), btl)
    for txid in have:
        led._transient.persist(txid, 0, plain[txid])
        jled._transient.persist(txid, 0, jm.TxPvtReadWriteSet.decode(
            plain[txid].encode()))
    key, _value = keys[forged]
    led._transient.persist(forged, 0, _pvt(m, key, b"forged"))
    jled._transient.persist(forged, 0, _pvt(jm, key, b"forged"))
    committer = world.committer(sw.SwVerifier(), ledger=led)

    def rows(ledger):
        return [(k, bytes(v), tuple(ver)) for k, v, ver in
                ledger.state.get_state_range(PNS, "", "")]
    for i, raw in enumerate(blocks):
        flags = committer.store_block(m.Block.decode(raw))
        assert set(flags) == {V.VALID}
        assert jled.commit_block(jm.Block.decode(raw), flags) == flags
        assert rows(led) == rows(jled)
        assert led.missing_pvt(500) == jled.missing_pvt(500)
        assert led.state_fingerprint() == jled.state_fingerprint() == \
            led.state_fingerprint_full()
        if i == 2:
            # both private blocks in: the plaintext held, a digest for
            # every other private tx (the forged one included)
            assert len(rows(led)) == len(have)
            assert led.missing_pvt_count() == len(txids) - len(have)
            missing = led.missing_pvt(500)
            loc = {}
            for num, raw_b in enumerate(blocks):
                for tn, env in enumerate(protoutil.get_envelopes(
                        m.Block.decode(raw_b))):
                    loc[protoutil.envelope_channel_header(env).tx_id] = \
                        (num, tn)
            kv_of = {loc[t]: m.KVRWSet.decode(
                plain[t].ns_pvt_rwset[0].collection_pvt_rwset[0].rwset)
                for t in txids}
            bn, tn, ns, coll = missing[0]
            bad = m.KVRWSet(writes=[m.KVWrite(key="x", value=b"forged")])
            assert led.reconcile_pvt(bn, tn, ns, coll, bad) is \
                jled.reconcile_pvt(bn, tn, ns, coll,
                                   jm.KVRWSet.decode(bad.encode())) is False
            for bn, tn, ns, coll in missing:
                kv = kv_of[(bn, tn)]
                assert led.reconcile_pvt(bn, tn, ns, coll, kv) is \
                    jled.reconcile_pvt(bn, tn, ns, coll,
                                       jm.KVRWSet.decode(kv.encode())) \
                    is True
            assert led.missing_pvt() == jled.missing_pvt() == []
            assert len(rows(led)) == len(txids)
            assert rows(led) == rows(jled)
            assert led.state_fingerprint() == jled.state_fingerprint() == \
                led.state_fingerprint_full()
    # blocks 1-2 purged while blocks 4-5 committed (BTL 2)
    assert rows(led) == rows(jled) == []
    assert led.get_pvt(1, 0) == []
    # the transient store kept nothing of the committed txs
    assert all(led._transient.get_by_txid(t) == [] for t in txids)
    fp = led.state_fingerprint()
    led.close()
    jled.close()
    again = KvLedger(world.channel_id, str(tmp_path / "p"))
    assert again.replayed_blocks == 0 and again.state_fingerprint() == fp
    again.close()


def test_btl_purge_is_version_matched(pvt_stream, tmp_path):
    """A key rewritten after its first write keeps its own BTL window
    (reference tests/test_pvtdata.py:139)."""
    world, _blocks, _plain, _keys = pvt_stream
    led = KvLedger(world.channel_id, str(tmp_path / "l"))
    ts = pvtdata.TransientStore()
    led.attach_pvt(ts, pvtdata.PvtDataStore(), lambda ns, coll: 2)
    committer = world.committer(sw.SwVerifier(), ledger=led)
    prev = b""
    for num in range(6):
        rw = RWSetBuilder()
        if num in (0, 1):
            rw.add_pvt_write(NS, COL, "k", b"v%d" % num)
        else:
            rw.add_write(NS, "pad%d" % num, b"x")
        nonce = b"btl-%020d" % num
        env = fixtures._signed_tx(world, rw.build().encode(),
                                  ("Org1", "Org2"), nonce, 1000 + num)
        if num in (0, 1):
            ts.persist(protoutil.envelope_channel_header(env).tx_id, num,
                       rw.build_pvt())
        block = protoutil.new_block(num, prev, [env])
        prev = protoutil.block_header_hash(block.header)
        assert committer.store_block(block) == [V.VALID]
        got = led.new_query_executor().get_private_data(NS, COL, "k")
        # the first write expires at block 3, the rewrite at block 4
        assert got == {0: b"v0", 1: b"v1", 2: b"v1", 3: b"v1"}.get(num)
        assert led.state_fingerprint() == led.state_fingerprint_full()
    led.close()


def test_has_pvt_tx_keeps_its_plaintext_with_stage_time_rwsets(pvt_stream):
    """The regression: blocks of 20 txs take the columnar decode at
    stage time, and the Committer hands its rwsets to commit_block; a
    pvt-bearing tx must still take the materialized rwset while a
    transient store is attached, or its plaintext is lost."""
    world, blocks, plain, keys = pvt_stream
    led = KvLedger(world.channel_id)
    ts = pvtdata.TransientStore()
    led.attach_pvt(ts, pvtdata.PvtDataStore())
    for txid, pvt in plain.items():
        ts.persist(txid, 0, pvt)
    committer = world.committer(sw.SwVerifier(), ledger=led)
    for raw in blocks[:3]:
        committer.store_block(m.Block.decode(raw))
        assert committer.last_timings["body_fallbacks"] in (None, 0)
    assert committer.last_timings["body_fallbacks"] == 0
    qe = led.new_query_executor()
    for key, value in keys.values():
        assert qe.get_private_data(NS, COL, key) == value
    assert led.missing_pvt_count() == 0
    led.close()


def test_e2e_private_roundtrip():
    """putpvt through Network.invoke(transient=): the ordered block
    carries only hashes, the commit applies the plaintext from the
    transient store, getpvt reads it back, the transient store is
    purged; a definition of col1 (BTL 1) committed first then expires it
    (reference tests/test_pvtdata.py:73-113, :116)."""
    material = fixtures.make_network_material(
        5, max_message_count=1, batch_timeout="60s")
    world = fixtures.network_world(material)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material, verifier=sw.SwVerifier())
        try:
            assert net.ledger.durable
            defs, _plain, _keys = fixtures.make_pvt_blocks(
                world, 0, 0, btl=1, first_block=1, prev_hash=b"")
            definition = protoutil.get_envelopes(m.Block.decode(defs[0]))[0]
            net.broadcast.submit(definition)
            assert e2e.commit_until(net, 1, 60)[1] == 1
            txid = net.invoke([b"putpvt", COL.encode(), b"acct"],
                              transient={"value": b"hidden-value"})
            assert e2e.commit_until(net, 2, 60)[1] == 2
            blk = net.ledger.get_block_by_number(2)
            assert b"hidden-value" not in blk.encode()
            assert protoutil.block_txflags(blk)[0] == V.VALID
            qe = net.ledger.new_query_executor()
            assert qe.get_private_data(NS, COL, "acct") == b"hidden-value"
            sp, _prop, _txid = protoutil.create_chaincode_proposal(
                net.channel_id, NS, [b"getpvt", COL.encode(), b"acct"],
                net.client)
            resp = net.endorsers["Org1"].process_proposal(sp)
            assert resp.response.status == 200
            assert resp.response.payload == b"hidden-value"
            assert net.channel.transient_store.get_by_txid(txid) == []
            # BTL 1: the data of block 2 is purged while block 4 commits
            net.invoke([b"put", b"pad1", b"x"])
            assert e2e.commit_until(net, 3, 60)[1] == 3
            assert qe.get_private_data(NS, COL, "acct") == b"hidden-value"
            net.invoke([b"put", b"pad2", b"x"])
            assert e2e.commit_until(net, 4, 60)[1] == 4
            assert net.ledger.new_query_executor().get_private_data(
                NS, COL, "acct") is None
            assert net.ledger.state_fingerprint() == \
                net.ledger.state_fingerprint_full()
        finally:
            net.close()
