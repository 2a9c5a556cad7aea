"""Gossip meshes of both packages on the same ordered blocks, and the
port's 50-peer push.

The reference's `Network` orders three 8-tx blocks of
`make_e2e_stream` (every planted kind; endorsed by a port Network on the
reference's material, which `convert.network_material_from_reference`
carries across as bytes).  Three reference peers (host verifier) and
three port peers — one `GpuVerifier(device="cpu")` shared by the three,
as one card is shared on the chip — with the same identities (issued by
the reference's CAs) then run the same steps on their own in-process
networks: the leader commits each block and pushes it; block 2 is
pushed while one follower is partitioned away, so that follower's gap
is filled by anti-entropy once block 3 shows it; a copy of block 3 with
one flipped byte in the orderer's signature is pushed before the real
block 3 and committed by no peer.  After every step the heights agree
across the packages, and at the end every peer's txflags are the
construction's and every state fingerprint is the same.

The second test pushes one block into 50 port peers (host verifier,
membership seeded directly as the reference's bench.py:2229 does): the
push runs depth-first on the caller's thread through every peer, and
every peer must commit it with nothing raised or kept in an error list.
"""
import os

import pytest
import torch
from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.gossip import InProcNetwork as JInProcNetwork
from fabric_mod_tpu.msp import ca as jcalib
from fabric_mod_tpu.orderer import BroadcastError as JBroadcastError
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from tests._torch_gossip_world import PortPeer, RefPeer, seed_membership
from fabric_mod_tpu_torch import convert, e2e
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block \
    as p_config_from_block
from fabric_mod_tpu_torch.gossip import InProcNetwork
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

BLOCK_TXS, N_BLOCKS = 8, 3
ORGS = ("Org1", "Org2", "Org3")
STORM_PEERS = 50


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the GpuVerifier's CPU path is many small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ordered_blocks(ref, root):
    """The reference orders three blocks of the planted stream, endorsed
    by a port Network on its material; (raw blocks, expected flags)."""
    port = e2e.Network(os.path.join(root, "endorse"),
                       material=convert.network_material_from_reference(ref),
                       verifier=sw.SwVerifier())
    try:
        submits, want = fixtures.make_e2e_stream(
            port, BLOCK_TXS * N_BLOCKS, plant_every=BLOCK_TXS)
    finally:
        port.close()
    for env, ok in submits:
        try:
            ref.broadcast.submit(jm.Envelope.decode(env.encode()))
            assert ok, "a tampered creator was accepted"
        except JBroadcastError:
            assert not ok
    store = ref.support.store
    assert ref.pump_committed(BLOCK_TXS * N_BLOCKS, timeout=120) == \
        BLOCK_TXS * N_BLOCKS
    assert store.height == N_BLOCKS + 1
    blocks = [store.get_block_by_number(n).encode()
              for n in range(1, N_BLOCKS + 1)]
    return blocks, [want[b * BLOCK_TXS:(b + 1) * BLOCK_TXS]
                    for b in range(N_BLOCKS)]


def _run_steps(peers, fabric, blocks, msgs, check):
    """The same steps on either package's mesh; `check(label)` after
    each compares heights with the other package's."""
    leader, follower, other = (p.node for p in peers)
    decoded = [msgs.Block.decode(raw) for raw in blocks]

    def lead(block):
        assert leader.state.add_block(block)
        assert leader.state.drain() == 1
        leader.gossip_block(block)

    def drain_all():
        for p in peers:
            p.node.state.drain()

    lead(decoded[0])
    drain_all()
    check("block 1 pushed")
    fabric.partitioned.add(follower.endpoint)
    lead(decoded[1])
    fabric.partitioned.clear()
    drain_all()
    check("block 2 pushed around the partitioned follower")
    leader.gossip_block(msgs.Block.decode(
        fixtures.tamper_block_signature(blocks[2])))
    drain_all()
    check("a tampered block 3 pushed")
    lead(decoded[2])
    drain_all()
    check("block 3 pushed")
    assert follower.state.buffer.missing_range() == range(2, 3)
    for _ in range(20):
        follower.state.anti_entropy_tick()
        follower.state.drain()
        if follower._channel.ledger.height == N_BLOCKS + 1:
            break
    check("anti-entropy")


def test_port_and_reference_meshes_converge(tmp_path, monkeypatch):
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE", "FABRIC_MOD_TPU_RELAY"):
        monkeypatch.delenv(knob, raising=False)
    root = str(tmp_path)
    ref = JNetwork(os.path.join(root, "ref"), max_message_count=BLOCK_TXS,
                   batch_timeout="60s")
    ref_peers, port_peers = [], []
    try:
        blocks, want = _ordered_blocks(ref, root)
        material = convert.network_material_from_reference(ref)
        # one identity a peer, the same in both meshes
        issued = [ref.cas[ORGS[i]].issue(f"gossip{i}.{ORGS[i].lower()}",
                                         ORGS[i], ous=["peer"])
                  for i in range(3)]
        jfabric, fabric = JInProcNetwork(), InProcNetwork()
        for i, (cert, key) in enumerate(issued):
            ref_peers.append(RefPeer(
                root, i, ref.genesis_block.encode(),
                (ORGS[i], jcalib.cert_pem(cert), jcalib.key_pem(key)),
                jfabric))
        verifier = gpu.GpuVerifier(device="cpu", buckets=(32,))
        for i, (cert, key) in enumerate(issued):
            port_peers.append(PortPeer(
                root, i, material.genesis,
                (ORGS[i], jcalib.cert_pem(cert), jcalib.key_pem(key)),
                fabric, verifier))
        assert [p.node.pki_id for p in port_peers] == \
            [p.node.pki_id for p in ref_peers]
        seed_membership([p.node for p in ref_peers], jm)
        seed_membership([p.node for p in port_peers], m)

        heights = {}

        def ref_check(label):
            heights[label] = [p.ledger.height for p in ref_peers]

        def port_check(label):
            assert [p.ledger.height for p in port_peers] == \
                heights[label], label

        _run_steps(ref_peers, jfabric, blocks, jm, ref_check)
        assert heights["block 2 pushed around the partitioned follower"] \
            == [3, 2, 3]
        assert heights["a tampered block 3 pushed"] == [3, 2, 3]
        assert heights["anti-entropy"] == [N_BLOCKS + 1] * 3
        _run_steps(port_peers, fabric, blocks, m, port_check)

        ordered = [[bytes(d) for d in jm.Block.decode(raw).data.data]
                   for raw in blocks]
        for peers, pu in ((ref_peers, jprotoutil), (port_peers, protoutil)):
            for p in peers:
                got = [p.ledger.get_block_by_number(n)
                       for n in range(1, N_BLOCKS + 1)]
                assert [list(pu.block_txflags(b)) for b in got] == want
                assert [[bytes(d) for d in b.data.data] for b in got] == \
                    ordered
        fingerprints = {p.ledger.state_fingerprint()
                        for p in ref_peers + port_peers}
        assert len(fingerprints) == 1
        for p in port_peers:
            assert p.node.state.errors == [] and p.node.state.stale == 0
    finally:
        for p in port_peers:
            p.close()
        for p in ref_peers:
            p.close()
        ref.close()


def test_one_push_reaches_fifty_peers(tmp_path):
    """Depth-first through 50 peers on the pushing thread: no frame
    limit is hit and nothing is swallowed."""
    material = fixtures.make_network_material(
        3, max_message_count=BLOCK_TXS, batch_timeout="60s",
        gossip_peers=STORM_PEERS)
    root = str(tmp_path)
    net = e2e.Network(os.path.join(root, "net"), material=material,
                      verifier=sw.SwVerifier())
    peers = []
    try:
        submits, want = fixtures.make_e2e_stream(net, BLOCK_TXS,
                                                 plant_every=BLOCK_TXS)
        for env, ok in submits:
            if ok:
                net.broadcast.submit(env)
        assert e2e.commit_until(net, BLOCK_TXS, 120)[1] == BLOCK_TXS
        block = net.support.store.get_block_by_number(1)
        fabric = InProcNetwork()
        # one bundle: the 50 mappers validate each identity once
        channel_id, config = p_config_from_block(
            m.Block.decode(material.genesis))
        bundle = Bundle(channel_id, config, net.csp)
        verifier = sw.SwVerifier()
        for i, pems in enumerate(material.gossip_peers):
            peers.append(PortPeer(root, i, material.genesis, pems, fabric,
                                  verifier, bundle=bundle, seed=i))
        seed_membership([p.node for p in peers], m)
        leader = peers[0].node
        assert leader.state.add_block(block) and leader.state.drain() == 1
        leader.gossip_block(block)
        for p in peers:
            p.node.state.drain()
        assert [p.ledger.height for p in peers] == [2] * STORM_PEERS
        assert {tuple(protoutil.block_txflags(p.ledger.get_block_by_number(1)))
                for p in peers} == {tuple(want)}
        assert all(p.node.state.errors == [] for p in peers)
    finally:
        for p in peers:
            p.close()
        net.close()
