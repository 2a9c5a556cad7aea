"""Gossip's private-data paths in the port (mirrors tests/test_gossip.py:
172-268): three peers (Org1, Org2, Org3), each a durable ledger, a
Channel and a GossipNode on one in-process network, joined by signed
alive messages, commit a definition of col1 (members Org1 and Org2) and
a block with private writes whose plaintext only Org1 holds.
`distribute_pvt` reaches the eligible peer only; a private message for
another channel is dropped; Org2 reconciles its missing digests from
Org1 and rejects a forged response; Org3, ineligible, asks and gets
nothing.  Host verifier (bccsp/sw.py).

The last test mixes the packages on one network: Org1 and Org3 of one
package, Org2 of the other, both ways round.  Each package's
`distribute_pvt` reaches the other's Org2 and not Org3; each serves the
other's reconciliation and refuses the other's ineligible Org3; every
peer of both packages gives the same eligibility verdicts."""
import pytest
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.gossip import InProcNetwork
from fabric_mod_tpu_torch.ledger.pvtdata import pvt_namespace
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

from tests._torch_gossip_world import PortPeer, RefPeer, seed_membership

NS, COL = fixtures.NAMESPACE, fixtures.PVT_COLLECTION


@pytest.fixture
def world(tmp_path):
    material = fixtures.make_network_material(7, gossip_peers=3)
    genesis = m.Block.decode(material.genesis)
    blocks, plain, keys = fixtures.make_pvt_blocks(
        fixtures.network_world(material), 1, 20, pvt_every=4,
        first_block=1, prev_hash=protoutil.block_header_hash(genesis.header))
    network = InProcNetwork()
    peers = [PortPeer(str(tmp_path), i, material.genesis, pems, network,
                      sw.SwVerifier(), seed=i)
             for i, pems in enumerate(material.gossip_peers)]
    assert [p.node._signer.mspid for p in peers] == ["Org1", "Org2", "Org3"]
    for p in peers:
        p.node.join([q.node.endpoint for q in peers])
    yield peers, blocks, plain, keys
    for p in peers:
        p.close()


def _commit(peers, blocks, plain):
    for txid, pvt in plain.items():
        peers[0].channel.transient_store.persist(txid, 0, pvt)
    for raw in blocks:
        for p in peers:
            assert set(p.channel.store_block(m.Block.decode(raw))) == {
                m.TxValidationCode.VALID}


def _rows(peer):
    return {k: v for k, v, _ver in peer.ledger.state.get_state_range(
        pvt_namespace(NS, COL), "", "")}


def test_private_data_distribution_respects_membership(world):
    peers, blocks, plain, _keys = world
    _commit(peers, blocks[:1], {})          # the collection's definition
    org1, org2, org3 = peers
    policy = org1.channel.collection_policy(NS, COL)
    assert policy is not None
    assert org1.channel._collection_btl(NS, COL) == 2
    eligible = org1.node.eligibility_by_policy(policy)
    txid, pvt = sorted(plain.items())[0]
    assert org1.node.distribute_pvt(txid, pvt, eligible) == 1
    got = org2.channel.transient_store.get_by_txid(txid)
    assert [g.encode() for g in got] == [pvt.encode()]
    assert org3.channel.transient_store.get_by_txid(txid) == []
    # the filter is what decides: one that admits nobody sends nothing
    assert org1.node.distribute_pvt("tx-none", pvt, lambda _i: False) == 0


def test_private_message_for_another_channel_is_dropped(world):
    peers, _blocks, plain, _keys = world
    org1, org2, _org3 = peers
    txid, pvt = sorted(plain.items())[0]
    for channel, stored in ((b"otherchannel", False),
                            (org2.channel.channel_id.encode(), True)):
        org1.node.comm.send(org2.node.endpoint, m.GossipMessage(
            nonce=1, channel=channel, private_data=m.PvtDataElement(
                txid=txid, payload=pvt.encode())))
        assert bool(org2.channel.transient_store.get_by_txid(txid)) is stored


def test_pvt_reconciliation_pulls_missing_data(world):
    peers, blocks, plain, keys = world
    _commit(peers, blocks, plain)
    org1, org2, org3 = peers
    want = {k: v for k, v in keys.values()}
    assert _rows(org1) == want
    assert _rows(org2) == _rows(org3) == {}
    n_private = len(plain)
    assert org2.ledger.missing_pvt_count() == n_private
    assert org3.ledger.missing_pvt_count() == n_private
    # a forged response is rejected by the ledger, the digest stays
    bn, tn, ns, coll = org2.ledger.missing_pvt()[0]
    forged = m.KVRWSet(writes=[m.KVWrite(key="p", value=b"forged")])
    org1.node.comm.send(org2.node.endpoint, m.GossipMessage(
        nonce=2, channel=org2.channel.channel_id.encode(),
        pvt_resp=m.PvtDataResponse(nonce=3, elements=[
            m.PvtDataResponseElement(
                digest=m.PvtDataDigest(block_num=bn, tx_num=tn,
                                       namespace=ns, collection=coll),
                rwset=forged.encode())])))
    assert org2.ledger.missing_pvt_count() == n_private
    assert _rows(org2) == {}
    # the eligible Org2 peer reconciles from Org1
    assert org2.node.reconcile_tick() == n_private
    assert _rows(org2) == want
    assert org2.ledger.missing_pvt() == []
    assert org2.ledger.state_fingerprint() == \
        org1.ledger.state_fingerprint() == \
        org2.ledger.state_fingerprint_full()
    # the ineligible Org3 peer asks both and learns nothing
    assert org3.node.reconcile_tick() == n_private
    assert _rows(org3) == {}
    assert org3.ledger.missing_pvt_count() == n_private
    assert org2.node.reconcile_tick() == 0


@pytest.mark.parametrize("org1_pkg", ["reference", "port"])
def test_private_data_crosses_packages(tmp_path, monkeypatch, org1_pkg):
    """Org1 and Org3 of `org1_pkg`, Org2 of the other package."""
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE", "FABRIC_MOD_TPU_RELAY"):
        monkeypatch.delenv(knob, raising=False)
    material = fixtures.make_network_material(7, gossip_peers=3)
    genesis = m.Block.decode(material.genesis)
    blocks, plain, keys = fixtures.make_pvt_blocks(
        fixtures.network_world(material), 1, 20, pvt_every=4,
        first_block=1, prev_hash=protoutil.block_header_hash(genesis.header))
    network = InProcNetwork()
    pkgs = [org1_pkg, {"reference": "port", "port": "reference"}[org1_pkg],
            org1_pkg]
    peers = [RefPeer(str(tmp_path), i, material.genesis, pems, network,
                     seed=i) if pkg == "reference" else
             PortPeer(str(tmp_path), i, material.genesis, pems, network,
                      sw.SwVerifier(), seed=i)
             for i, (pkg, pems) in enumerate(zip(pkgs,
                                                 material.gossip_peers))]
    msgs = {"reference": jm, "port": m}
    try:
        org1, org2, org3 = peers
        seed_membership([p.node for p in peers],
                        lambda node: jm if node.__module__.startswith(
                            "fabric_mod_tpu.") else m)
        for p, pkg in zip(peers, pkgs):
            decoded = msgs[pkg].Block.decode(blocks[0])
            assert set(p.channel.store_block(decoded)) == {
                m.TxValidationCode.VALID}
        # the same member-orgs policy and the same verdicts everywhere
        policies = {p.channel.collection_policy(NS, COL).encode()
                    for p in peers}
        assert len(policies) == 1
        identities = [p.node._identity for p in peers] + [b"", b"\x0a\x01"]
        for p in peers:
            eligible = p.node.eligibility_by_policy(
                p.channel.collection_policy(NS, COL))
            assert [eligible(i) for i in identities] == \
                [True, True, False, False, False], type(p).__name__
        # each package's distribution reaches the other's Org2 only
        (txid, pvt), *rest = sorted(plain.items())
        eligible = org1.node.eligibility_by_policy(
            org1.channel.collection_policy(NS, COL))
        assert org1.node.distribute_pvt(
            txid, msgs[pkgs[0]].TxPvtReadWriteSet.decode(pvt.encode()),
            eligible) == 1
        assert [g.encode() for g in
                org2.channel.transient_store.get_by_txid(txid)] == \
            [pvt.encode()]
        assert org3.channel.transient_store.get_by_txid(txid) == []
        for t, rw in plain.items():
            org1.channel.transient_store.persist(
                t, 0, msgs[pkgs[0]].TxPvtReadWriteSet.decode(rw.encode()))
        for p, pkg in zip(peers, pkgs):
            decoded = msgs[pkg].Block.decode(blocks[1])
            assert set(p.channel.store_block(decoded)) == {
                m.TxValidationCode.VALID}
        want = {k: v for k, v in keys.values()}
        assert _rows(org1) == want
        assert _rows(org2) == {keys[txid][0]: keys[txid][1]}
        assert _rows(org3) == {}
        assert org2.ledger.missing_pvt_count() == len(rest)
        # Org1 serves the other package's Org2
        assert org2.node.reconcile_tick() == len(rest)
        assert _rows(org2) == want and org2.ledger.missing_pvt() == []
        assert org2.ledger.state_fingerprint() == \
            org1.ledger.state_fingerprint()
        # both packages refuse the ineligible Org3
        assert org3.node.reconcile_tick() == len(plain)
        assert _rows(org3) == {}
        assert org3.ledger.missing_pvt_count() == len(plain)
        for p, pkg in zip(peers, pkgs):
            if pkg == "port":
                assert p.ledger.state_fingerprint() == \
                    p.ledger.state_fingerprint_full()
                assert p.node.state.errors == []
    finally:
        for p in peers:
            p.close()
