"""Channel participation in the port (fabric_mod_tpu_torch/orderer/
participation.py and the registrar's join / remove / follower marker),
mirroring tests/test_participation.py and held to the reference's
fabric_mod_tpu/orderer/participation.py:

* join from genesis, list, a double join refused, remove and rejoin;
* join from a later config block: the chain is replicated, checked and
  stored byte for byte as the source's, by the port and by the
  reference joining the same source;
* a follower pulls the source's blocks byte for byte, refuses Broadcast,
  and stays a follower across a reopen;
* a forged history and a source with one flipped orderer-signature byte
  are refused: the join raises, nothing half-joined comes up on reopen,
  an honest rejoin completes, and a follower stops at the tampered
  block.
"""
import time

import pytest

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.channelconfig import (compute_update,
                                                signed_update_envelope)
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.orderer.consensus import ChainHaltedError
from fabric_mod_tpu_torch.orderer.participation import (
    ChannelParticipation, FollowerChain, ParticipationError)
from fabric_mod_tpu_torch.orderer.registrar import Registrar, RegistrarError
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

CHANNEL = "partchan"


@pytest.fixture()
def world(tmp_path):
    mat = fixtures.make_network_material(
        41, CHANNEL, max_message_count=3, batch_timeout="100ms")
    csp = sw.SwCSP()
    reg1 = Registrar(str(tmp_path / "ord1"), _signer(csp, mat.orderer), csp)
    reg1.create_channel(m.Block.decode(mat.genesis))
    w = {"mat": mat, "csp": csp, "reg1": reg1, "tmp": tmp_path,
         "client": _signer(csp, mat.client), "regs": []}
    yield w
    for reg in w["regs"]:
        reg.close()
    reg1.close()


def _registrar(world, name, **kwargs):
    reg = Registrar(str(world["tmp"] / name),
                    _signer(world["csp"], world["mat"].orderer),
                    world["csp"], **kwargs)
    world["regs"].append(reg)
    return reg


def _env(world, k):
    signer = world["client"]
    ch = protoutil.make_channel_header(
        m.HeaderType.ENDORSER_TRANSACTION, CHANNEL, tx_id=f"part-{k}")
    sh = protoutil.make_signature_header(signer.serialize(),
                                         protoutil.new_nonce())
    return protoutil.sign_envelope(
        protoutil.make_payload(ch, sh, b"part-%d" % k), signer)


def _order_txs(world, n, start=0):
    support = world["reg1"].get_chain(CHANNEL)
    for k in range(start, start + n):
        support.chain.order(_env(world, k), support.sequence())
    _wait(lambda: sum(len(support.store.get_block_by_number(i).data.data)
                      for i in range(1, support.store.height))
          >= start + n)


def _wait(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError("timed out")


def _commit_config_update(world):
    """A batch-size update (3 -> 5) through the source: the CONFIG block
    at height > 0 a join anchors to."""
    support = world["reg1"].get_chain(CHANNEL)
    cur = support.bundle().config
    desired = fixtures.config_with_batch_size(cur, 5)
    admin = _signer(world["csp"], world["mat"].orderer_admin)
    env = signed_update_envelope(
        CHANNEL, compute_update(CHANNEL, cur, desired.channel_group),
        [admin])
    wrapped, seq = support.processor.process_config_update_msg(env)
    support.chain.configure(wrapped, seq)
    _wait(lambda: support.bundle().sequence == 1)
    lc = support.writer.last_config
    assert lc > 0
    return support.store.get_block_by_number(lc)


def _fetcher_from(support, tamper=None):
    """The source's blocks; `tamper` maps a height to a function of the
    encoded block."""
    def fetch(lo, hi):
        top = support.store.height if hi == 0 else min(
            hi, support.store.height)
        out = []
        for i in range(lo, top):
            raw = support.store.get_block_by_number(i).encode()
            if tamper and i in tamper:
                raw = tamper[i](raw)
            out.append(m.Block.decode(raw))
        return out
    return fetch


def _chain_bytes(store):
    return [store.get_block_by_number(i).encode()
            for i in range(store.height)]


def test_join_from_genesis_list_remove_and_rejoin(world):
    reg2 = _registrar(world, "ord2")
    part = ChannelParticipation(reg2)
    genesis = m.Block.decode(world["mat"].genesis)
    info = part.join(genesis)
    assert info.channel_id == CHANNEL
    assert part.list_channels() == [
        {"name": CHANNEL, "height": 1, "status": "active"}]
    with pytest.raises(ParticipationError):
        part.join(genesis)                         # a double join
    part.remove(CHANNEL)
    assert reg2.get_chain(CHANNEL) is None
    with pytest.raises(ParticipationError):
        part.channel_info(CHANNEL)
    with pytest.raises(RegistrarError):
        reg2.remove_channel(CHANNEL)
    part.join(genesis)                             # storage was deleted
    assert part.channel_info(CHANNEL)["height"] == 1


def test_join_from_a_later_config_block_replicates_byte_for_byte(world):
    _order_txs(world, 7)
    join_block = _commit_config_update(world)
    src = world["reg1"].get_chain(CHANNEL)
    reg2 = _registrar(world, "ord2")
    support2 = ChannelParticipation(
        reg2, block_fetcher=_fetcher_from(src)).join(join_block)
    h = join_block.header.number + 1
    assert support2.store.height == h
    assert _chain_bytes(support2.store) == _chain_bytes(src.store)[:h]
    # the joined channel runs the joined config and orders
    assert support2.bundle().sequence == 1
    assert support2.cutter.config.max_message_count == 5
    assert not (world["tmp"] / "ord2" / CHANNEL / ".joining").exists()


def test_reference_joining_the_same_source_stores_the_same_bytes(world):
    """The reference's registrar joins the port's source from the same
    config block: both joined stores hold the source's bytes."""
    from cryptography import x509 as jx509
    from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
    from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
    from fabric_mod_tpu.orderer.participation import \
        ChannelParticipation as JParticipation
    from fabric_mod_tpu.orderer.registrar import Registrar as JRegistrar
    from fabric_mod_tpu.protos import messages as jm
    _order_txs(world, 5)
    join_block = _commit_config_update(world)
    _order_txs(world, 4, start=5)
    src = world["reg1"].get_chain(CHANNEL)
    h = join_block.header.number + 1
    port_fetch = _fetcher_from(src)
    reg2 = _registrar(world, "ord2")
    ChannelParticipation(reg2, block_fetcher=port_fetch).join(join_block)
    mspid, cert_pem, key_pem = world["mat"].orderer
    jcsp = JSwCSP()
    jreg = JRegistrar(str(world["tmp"] / "ref"), JSigner(
        mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem, jcsp),
        jcsp)
    try:
        JParticipation(jreg, block_fetcher=lambda lo, hi: [
            jm.Block.decode(b.encode()) for b in port_fetch(lo, hi)]).join(
            jm.Block.decode(join_block.encode()))
        jstore = jreg.get_chain(CHANNEL).store
        ref_bytes = [jstore.get_block_by_number(i).encode()
                     for i in range(jstore.height)]
    finally:
        jreg.close()
    assert ref_bytes == _chain_bytes(reg2.get_chain(CHANNEL).store) == \
        _chain_bytes(src.store)[:h]


def test_follower_pulls_byte_for_byte_and_survives_reopen(world):
    _order_txs(world, 4)
    src = world["reg1"].get_chain(CHANNEL)
    fetch = _fetcher_from(src)
    reg2 = Registrar(str(world["tmp"] / "ord2"),
                     _signer(world["csp"], world["mat"].orderer),
                     world["csp"], block_fetcher=fetch)
    part = ChannelParticipation(reg2)
    support2 = part.join(m.Block.decode(world["mat"].genesis),
                         as_follower=True)
    _wait(lambda: support2.store.height == src.store.height)
    assert _chain_bytes(support2.store) == _chain_bytes(src.store)
    assert part.channel_info(CHANNEL)["status"] == "follower"
    with pytest.raises(ChainHaltedError):
        support2.chain.order(_env(world, 99), 0)
    reg2.close()
    # reopened: the marker keeps it a follower, and it keeps pulling
    # across a config block (its bundle follows)
    reg3 = _registrar(world, "ord2", block_fetcher=fetch)
    support3 = reg3.get_chain(CHANNEL)
    assert isinstance(support3.chain, FollowerChain)
    _commit_config_update(world)
    _order_txs(world, 5, start=4)
    _wait(lambda: support3.store.height == src.store.height)
    assert _chain_bytes(support3.store) == _chain_bytes(src.store)
    assert support3.bundle().sequence == 1
    assert support3.chain.rejected == [] and support3.chain.errors == []


def test_follower_without_a_source_is_refused(world):
    part = ChannelParticipation(_registrar(world, "ord2"))
    with pytest.raises(ParticipationError):
        part.join(m.Block.decode(world["mat"].genesis), as_follower=True)


def _forged_source(world):
    """Another orderer's chain of the same channel id from a different
    genesis: its history does not lead to the join block."""
    mat = fixtures.make_network_material(
        41, CHANNEL, max_message_count=2, batch_timeout="1s")
    reg = _registrar(world, "evil")
    support = reg.create_channel(m.Block.decode(mat.genesis))
    for k in range(12):
        support.chain.order(_env(world, k), 0)
    return support


def test_forged_history_refused_then_honest_rejoin(world):
    _order_txs(world, 4)
    join_block = _commit_config_update(world)
    evil = _forged_source(world)
    _wait(lambda: evil.store.height > join_block.header.number)
    reg2 = Registrar(str(world["tmp"] / "ord2"),
                     _signer(world["csp"], world["mat"].orderer),
                     world["csp"])
    with pytest.raises((ParticipationError, RegistrarError)):
        ChannelParticipation(reg2, block_fetcher=_fetcher_from(evil)).join(
            join_block)
    reg2.close()
    reg3 = _registrar(world, "ord2")
    assert reg3.get_chain(CHANNEL) is None         # .joining keeps it down
    src = world["reg1"].get_chain(CHANNEL)
    support3 = ChannelParticipation(
        reg3, block_fetcher=_fetcher_from(src)).join(join_block)
    assert support3.store.height == join_block.header.number + 1


def test_flipped_orderer_signature_is_refused(world):
    """One flipped byte in block 2's orderer signature leaves the hash
    chain and the anchor intact (the signature is metadata): the MCS
    check refuses it, on the join and on the follower's pull."""
    _order_txs(world, 6)
    join_block = _commit_config_update(world)
    src = world["reg1"].get_chain(CHANNEL)
    assert join_block.header.number > 2
    bad = _fetcher_from(src, {2: fixtures.tamper_block_signature})
    reg2 = Registrar(str(world["tmp"] / "ord2"),
                     _signer(world["csp"], world["mat"].orderer),
                     world["csp"])
    with pytest.raises(ParticipationError, match="block 2 refused"):
        ChannelParticipation(reg2, block_fetcher=bad).join(join_block)
    reg2.close()
    reg3 = _registrar(world, "ord2", block_fetcher=bad)
    assert reg3.get_chain(CHANNEL) is None
    follower = ChannelParticipation(reg3).join(
        m.Block.decode(world["mat"].genesis), as_follower=True)
    _wait(lambda: follower.chain.rejected == [2])
    time.sleep(0.5)                                # a few more polls
    assert follower.store.height == 2 and follower.chain.rejected == [2]
    assert _chain_bytes(follower.store) == _chain_bytes(src.store)[:2]


def test_raft_member_joins_from_a_config_block_and_orders(tmp_path):
    """A three-orderer Raft network adds orderer3 to its consenter set
    by a config update; orderer3 joins from that config block
    (replicating and checking the chain), then orders with the cluster;
    orderer4, not a member, follows.  The replicated blocks and the
    follower's whole chain equal the source's byte for byte; the blocks
    orderer3 built itself equal the source's but for its own
    signature."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.peer.mcs import MessageCryptoService
    mat = fixtures.make_network_material(
        43, CHANNEL, consensus_type="etcdraft", orderers=3,
        spare_orderers=2, max_message_count=8, batch_timeout="200ms")
    net = e2e.Network(str(tmp_path), material=mat, verifier=sw.SwVerifier(),
                      election_timeout=(1.0, 2.0), heartbeat_s=0.1)
    try:
        submits, _want = fixtures.make_e2e_stream(net, 32)
        envs = [env for env, ok in submits if ok]
        src = net.orderers[0].support

        def feed(batch):
            target = sum(len(src.store.get_block_by_number(i).data.data)
                         for i in range(1, src.store.height)) + len(batch)
            for env in batch:
                net.broadcast.submit(env)
            _wait(lambda: sum(
                len(src.store.get_block_by_number(i).data.data)
                for i in range(1, src.store.height)) >= target, 60)
        feed(envs[:len(envs) // 2])
        cur = src.bundle().config
        ids = list(src.bundle().orderer.consenters())
        desired = fixtures.config_with_consenters(cur, ids + ["orderer3"])
        net.broadcast.submit(signed_update_envelope(
            CHANNEL, compute_update(CHANNEL, cur, desired.channel_group),
            [_signer(net.csp, mat.orderer_admin)]))
        _wait(lambda: all(o.support.sequence() == 1 for o in net.orderers),
              60)
        join_block = src.store.get_block_by_number(src.writer.last_config)
        h = join_block.header.number + 1
        member = net.join_orderer("orderer3", join_block)
        follower = net.join_orderer("orderer4", m.Block.decode(mat.genesis),
                                    as_follower=True)
        assert isinstance(follower.support.chain, FollowerChain)
        assert _chain_bytes(member.support.store) == \
            _chain_bytes(src.store)[:h]
        feed(envs[len(envs) // 2:])
        _wait(lambda: all(o.support.store.height == src.store.height
                          for o in net.orderers), 60)
        assert src.store.height >= h + 2
        assert _chain_bytes(follower.support.store) == _chain_bytes(src.store)
        mine = member.support.store
        mcs = MessageCryptoService(member.support.bundle)
        for i in range(h, src.store.height):
            got, want = mine.get_block_by_number(i), \
                src.store.get_block_by_number(i)
            assert got.header.encode() == want.header.encode()
            assert got.data.encode() == want.data.encode()
            mcs.verify_block(CHANNEL, got)         # orderer3's own signature
            meta = m.Metadata.decode(got.metadata.metadata[
                m.BlockMetadataIndex.SIGNATURES])
            creator = m.SignatureHeader.decode(
                meta.signatures[0].signature_header).creator
            assert creator == _signer(net.csp,
                                      mat.consenters["orderer3"]).serialize()
        assert follower.support.chain.rejected == []
    finally:
        net.close()
