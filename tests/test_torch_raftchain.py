"""The port's RaftChain (fabric_mod_tpu_torch/orderer/raftchain.py) over
the port's Registrar, against three of the reference's RaftChains
(fabric_mod_tpu/orderer/raftchain.py) and the port's SoloChain.

One etcdraft genesis with three consenters (the seeded network
material, 100-tx blocks on count, a 60 s batch timeout that never
fires) starts three port orderers and three reference orderers, each
set over its own in-process transport on a manual clock.  The same
envelopes (`make_e2e_stream`'s accepted ones, 1,000 distinct, fed three
times over: 3,000) go to a follower of each cluster, with a batch-size
config update (100 -> 50 txs a block) after the first half, and to a
solo orderer in the same order.  Every node of a cluster must hold the
same chain (heights, header hashes, metadata slot 3, per-node
signatures), the data hashes must be equal across the port's nodes,
the reference's and the solo chain, the config block must land at the
same height everywhere, and a port node restarted over its WAL must
re-append nothing and keep ordering."""
import os
import random
import tempfile
import zlib

import pytest

from tests._clocksteps import advance_until, leader_known_by_all, settle

from cryptography import x509 as jx509
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import update as jupdate
from fabric_mod_tpu.channelconfig.bundle import BATCH_SIZE, ORDERER
from fabric_mod_tpu.channelconfig.configtx import (
    config_from_block as j_cfb, groups_of, set_group, set_value, values_of)
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.orderer.raft import RaftTransport as JTransport
from fabric_mod_tpu.orderer.raftchain import RaftChain as JRaftChain
from fabric_mod_tpu.orderer.registrar import Registrar as JRegistrar
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.utils.fakeclock import ManualClock as JClock

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.orderer import RaftChain, RaftTransport, Registrar
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

SEED = 9
CHANNEL = "raftchannel"
DISTINCT, REPEAT = 1000, 3
BLOCK, NEW_BLOCK = 100, 50
HALF = DISTINCT * REPEAT // 2


def _rng(oid):
    return random.Random(0xE1EC + zlib.crc32(oid.encode()))


def _ref_signer(pems):
    mspid, cert_pem, key_pem = pems
    return JSigner(mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem,
                   JSwCSP())


def _batch_size_update(mat):
    """The CONFIG_UPDATE envelope (bytes) setting max_message_count to
    NEW_BLOCK against `mat`'s genesis, signed by an orderer-org admin
    (the reference's update helpers: the port has no copy of
    channelconfig/update.py)."""
    _, jcfg = j_cfb(jm.Block.decode(mat.genesis))
    desired = jm.ConfigGroup.decode(jcfg.channel_group.encode())
    osec = groups_of(desired)[ORDERER]
    bsv = values_of(osec)[BATCH_SIZE]
    bs = jm.BatchSize.decode(bsv.value)
    bs.max_message_count = NEW_BLOCK
    bsv.value = bs.encode()
    set_value(osec, BATCH_SIZE, bsv)
    set_group(desired, ORDERER, osec)
    orderer_ca = calib.CA("ca.orderer", "OrdererOrg",
                          seed=b"network|%d" % SEED, now=fixtures.CERT_EPOCH)
    cert, key = orderer_ca.issue("admin@orderer", "OrdererOrg", ous=["admin"])
    admin = _ref_signer(("OrdererOrg", cert.pem(), calib.key_pem(key)))
    return jupdate.signed_update_envelope(
        CHANNEL, jupdate.compute_update(CHANNEL, jcfg, desired),
        [admin]).encode()


@pytest.fixture(scope="module")
def stream():
    """(the etcdraft material, the solo material of the same seed, the
    envelopes' bytes in feed order)."""
    batch = dict(max_message_count=BLOCK, batch_timeout="60s",
                 preferred_max_bytes=4 * 1024 * 1024)
    mat = fixtures.make_network_material(
        SEED, CHANNEL, consensus_type="etcdraft", orderers=3, **batch)
    solo = fixtures.make_network_material(SEED, CHANNEL, **batch)
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=solo, verifier=sw.SwVerifier())
        try:
            submits, _want = fixtures.make_e2e_stream(net, DISTINCT)
        finally:
            net.close()
    envs = [env.encode() for env, ok in submits if ok] * REPEAT
    return mat, solo, envs


class _Cluster:
    """Three orderers of one package over one transport and clock."""

    def __init__(self, pkg, mat, root):
        self.pkg, self.root, self.mat = pkg, root, mat
        self.ids = list(mat.consenters)
        if pkg == "port":
            self.clock, self.transport = ManualClock(), RaftTransport()
            self.msgs, self.csp = m, sw.SwCSP()
        else:
            self.clock, self.transport = JClock(), JTransport()
            self.msgs, self.csp = jm, JSwCSP()
        self.registrars = {oid: self.open(oid) for oid in self.ids}
        genesis = self.msgs.Block.decode(mat.genesis)
        for reg in self.registrars.values():
            reg.create_channel(genesis)
        assert advance_until(self.clock,
                             lambda: leader_known_by_all(self.chains()))

    def open(self, oid):
        def factory(support):
            cls = RaftChain if self.pkg == "port" else JRaftChain
            return cls(oid, list(self.ids), self.transport,
                       os.path.join(self.root, f"{oid}.wal"), support,
                       clock=self.clock, rng=_rng(oid))
        pems = self.mat.consenters[oid]
        if self.pkg == "port":
            return Registrar(os.path.join(self.root, oid),
                             _signer(self.csp, pems), self.csp,
                             chain_factory=factory)
        return JRegistrar(os.path.join(self.root, oid), _ref_signer(pems),
                          self.csp, chain_factory=factory)

    def supports(self):
        return {oid: reg.get_chain(CHANNEL)
                for oid, reg in self.registrars.items()}

    def chains(self):
        return {oid: s.chain for oid, s in self.supports().items()}

    def follower(self):
        return next(oid for oid, c in self.chains().items()
                    if not c.is_leader)

    def txs(self, oid):
        store = self.supports()[oid].store
        return sum(len(store.get_block_by_number(b).data.data)
                   for b in range(1, store.height))

    def wrap(self, update):
        """The orderer's CONFIG envelope for a CONFIG_UPDATE (bytes)."""
        wrapped, seq = self.supports()[self.ids[0]].processor \
            .process_config_update_msg(self.msgs.Envelope.decode(update))
        assert seq == 0
        return wrapped.encode()

    def feed(self, envs, config):
        """Half the envelopes, the CONFIG envelope, the other half, all
        through one follower; waits until every node stored them."""
        via = self.supports()[self.follower()]
        for raw in envs[:HALF]:
            via.chain.order(self.msgs.Envelope.decode(raw), 0)
        via.chain.configure(self.msgs.Envelope.decode(config), 0)
        assert settle(lambda: all(s.sequence() == 1
                                  for s in self.supports().values()),
                      timeout=60.0)
        for raw in envs[HALF:]:
            via.chain.order(self.msgs.Envelope.decode(raw), 1)
        assert settle(lambda: all(self.txs(oid) >= len(envs) + 1
                                  for oid in self.ids), timeout=120.0), \
            {oid: self.txs(oid) for oid in self.ids}

    def blocks(self, oid):
        """The node's chain, as the port's messages."""
        store = self.supports()[oid].store
        return [m.Block.decode(store.get_block_by_number(b).encode())
                for b in range(store.height)]

    def close(self):
        for reg in self.registrars.values():
            reg.close()


def _solo_blocks(solo, envs, root):
    """The same envelopes and a batch-size update (against the solo
    genesis) through the port's solo orderer."""
    update = _batch_size_update(solo)
    reg = Registrar(root, _signer(sw.SwCSP(), solo.orderer), sw.SwCSP())
    try:
        support = reg.create_channel(m.Block.decode(solo.genesis))
        for raw in envs[:HALF]:
            support.chain.order(m.Envelope.decode(raw), 0)
        wrapped, seq = support.processor.process_config_update_msg(
            m.Envelope.decode(update))
        support.chain.configure(wrapped, seq)
        for raw in envs[HALF:]:
            support.chain.order(m.Envelope.decode(raw), 1)
        want = 1 + HALF // BLOCK + 1 + HALF // NEW_BLOCK
        assert settle(lambda: support.store.height == want, timeout=120.0)
        return [support.store.get_block_by_number(b)
                for b in range(support.store.height)]
    finally:
        reg.close()


def _data_hashes(blocks):
    return [bytes(b.header.data_hash) for b in blocks[1:]]


def _is_config(block):
    payload = protoutil.unmarshal_envelope_payload(
        m.Envelope.decode(block.data.data[0]))
    return m.ChannelHeader.decode(
        payload.header.channel_header).type == m.HeaderType.CONFIG


def test_raft_clusters_order_the_same_chain(stream, tmp_path):
    mat, solo_mat, envs = stream
    clusters = {}
    try:
        # one CONFIG envelope (signed by a port orderer) for both clusters
        config = None
        for pkg in ("port", "reference"):
            clusters[pkg] = _Cluster(pkg, mat, str(tmp_path / pkg))
            config = config or clusters[pkg].wrap(_batch_size_update(mat))
            clusters[pkg].feed(envs, config)
        chains = {}
        for pkg, cl in clusters.items():
            per_node = {oid: cl.blocks(oid) for oid in cl.ids}
            heights = {len(b) for b in per_node.values()}
            assert heights == {1 + HALF // BLOCK + 1 + HALF // NEW_BLOCK}
            ref = per_node[cl.ids[0]]
            for oid, blocks in per_node.items():
                for b, r in zip(blocks[1:], ref[1:]):
                    assert protoutil.block_header_hash(b.header) == \
                        protoutil.block_header_hash(r.header)
                    assert bytes(b.metadata.metadata[3]) == \
                        bytes(r.metadata.metadata[3])
                    if oid != cl.ids[0]:        # each node signs its own
                        assert bytes(b.metadata.metadata[0]) != \
                            bytes(r.metadata.metadata[0])
            chains[pkg] = ref
        solo = _solo_blocks(solo_mat, envs, str(tmp_path / "solo"))
        assert _data_hashes(chains["port"]) == \
            _data_hashes(chains["reference"])
        # the solo config block differs (its ConsensusType and orderer
        # signature); every other block holds the same data
        cfg = 1 + HALF // BLOCK
        assert _data_hashes(solo)[:cfg - 1] == \
            _data_hashes(chains["port"])[:cfg - 1]
        assert _data_hashes(solo)[cfg:] == _data_hashes(chains["port"])[cfg:]
        assert [bytes(b.metadata.metadata[3]) for b in chains["port"][1:]] \
            == [bytes(b.metadata.metadata[3])
                for b in chains["reference"][1:]]
        # the batch-size update lands at the same height everywhere,
        # and the blocks after it hold the new count
        for blocks in (chains["port"], chains["reference"], solo):
            at = [b.header.number for b in blocks[1:] if _is_config(b)]
            assert at == [1 + HALF // BLOCK]
            assert {len(b.data.data) for b in blocks[at[0] + 1:]} == \
                {NEW_BLOCK}

        # a port follower restarted over its WAL re-appends nothing
        cl = clusters["port"]
        victim = cl.follower()
        before = cl.blocks(victim)
        cl.registrars[victim].close()
        cl.registrars[victim] = cl.open(victim)
        support = cl.supports()[victim]
        assert advance_until(cl.clock,
                             lambda: leader_known_by_all(cl.chains()))
        assert support.store.height == len(before)
        assert [protoutil.block_header_hash(b.header)
                for b in cl.blocks(victim)] == \
            [protoutil.block_header_hash(b.header) for b in before]
        lead = cl.supports()[next(o for o, c in cl.chains().items()
                                  if c.is_leader)]
        for raw in envs[:NEW_BLOCK]:
            lead.chain.order(m.Envelope.decode(raw), 1)
        assert settle(lambda: support.store.height == len(before) + 1,
                      timeout=60.0)
        assert protoutil.block_header_hash(
            support.store.get_block_by_number(len(before)).header) == \
            protoutil.block_header_hash(
                lead.store.get_block_by_number(len(before)).header)
    finally:
        for cl in clusters.values():
            cl.close()


@pytest.mark.parametrize("failures, raises", [(2, False), (None, True)],
                         ids=["leader-appears", "no-leader"])
def test_broadcast_retries_a_leaderless_consenter(monkeypatch, failures,
                                                  raises):
    """Broadcast.submit retries NotLeaderError with a backoff (the
    reference's retrier, broadcast.py:84-89) and re-raises it once the
    budget is spent."""
    import types

    from fabric_mod_tpu_torch.orderer import Broadcast, NotLeaderError
    from fabric_mod_tpu_torch.orderer import broadcast as bmod
    monkeypatch.setattr(bmod, "NOT_LEADER_RETRY_S", 0.3)
    calls = []

    def order(env, seq):
        calls.append(seq)
        if failures is None or len(calls) <= failures:
            raise NotLeaderError("election in progress")
    support = types.SimpleNamespace(
        channel_id=CHANNEL, chain=types.SimpleNamespace(order=order),
        processor=types.SimpleNamespace(process_normal_msg=lambda env: 7))
    registrar = types.SimpleNamespace(
        broadcast_channel_support=lambda env: (support, False))
    env = m.Envelope(payload=b"p", signature=b"s")
    if raises:
        with pytest.raises(NotLeaderError):
            Broadcast(registrar).submit(env)
        assert len(calls) >= 3                # 0.05 + 0.1 + 0.2 s > 0.3
    else:
        Broadcast(registrar).submit(env)
        assert calls == [7, 7, 7]
