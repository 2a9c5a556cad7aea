"""The end-to-end network on three Raft orderers, port against the solo
networks of both packages.

The JAX package's `Network` is built first (its own CAs, a solo
orderer, blocks of 8 on count, its host verifier); its material crosses
to the port as bytes (`convert.network_material_from_reference`), with
three orderer certificates signed by its orderer CA and an etcdraft
genesis over the same CAs listing them.  The port's `Network` on that
material runs three RaftChains over one in-process transport on a
manual clock (advanced only until the first leader is known, so no
other election can happen), and verifies with the GpuVerifier's CPU
path.  Three blocks of `make_e2e_stream` (every planted kind, and a
tampered creator that Broadcast rejects) go through a follower, which
forwards them to the leader.  Every flag must be the construction's,
the three orderers must hold the same chain, and the port's solo
`Network` and the reference's, fed the envelopes in the order the Raft
service cut them, must give the same flags and state fingerprint."""
import os
import threading
import time

import pytest
import torch
from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.msp import ca as jcalib
from fabric_mod_tpu.orderer import BroadcastError as JBroadcastError
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert, e2e
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.channelconfig import genesis
from fabric_mod_tpu_torch.orderer import BroadcastError
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

BLOCK_TXS, N_BLOCKS = 8, 3
IDS = ("orderer0", "orderer1", "orderer2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the GpuVerifier's CPU path is many small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raft_material(ref):
    """The reference network's material with an etcdraft genesis over its
    CAs and three consenters certified by its orderer CA."""
    base = convert.network_material_from_reference(ref)
    consenters = {}
    for oid in IDS:
        cert, key = ref.orderer_ca.issue(oid, "OrdererOrg", ous=["orderer"])
        consenters[oid] = ("OrdererOrg", jcalib.cert_pem(cert),
                           jcalib.key_pem(key))
    block = genesis.standard_network(
        ref.channel_id, {org: [pem] for org, pem in base.ca_pems.items()},
        {"OrdererOrg": [base.orderer_ca_pem]}, consensus_type="etcdraft",
        consenters=list(IDS), max_message_count=BLOCK_TXS,
        batch_timeout="60s")
    return e2e.NetworkMaterial(
        ca_pems=base.ca_pems, orderer_ca_pem=base.orderer_ca_pem,
        client=base.client, peers=base.peers, admins=base.admins,
        orderer=consenters[IDS[0]], genesis=block.encode(),
        consenters=consenters)


def _raft_network(root, material, verifier):
    """The port's Raft Network; a manual clock moves until the first
    leader is known to all, then stays frozen."""
    clock, built = ManualClock(), threading.Event()

    def pump():
        while not built.is_set():
            clock.advance(0.02)
            time.sleep(0.005)
    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        return e2e.Network(root, material=material, verifier=verifier,
                           tensor_policy=True, clock=clock)
    finally:
        built.set()
        pumper.join(timeout=10)


def _flags(ledger, pu):
    return [list(pu.block_txflags(ledger.get_block_by_number(b)))
            for b in range(1, ledger.height)]


def test_raft_network_equals_solo_networks(tmp_path, monkeypatch):
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE",
                 "FABRIC_MOD_TPU_STAGED_BROADCAST"):
        monkeypatch.delenv(knob, raising=False)
    n_tx = BLOCK_TXS * N_BLOCKS
    root = str(tmp_path)
    ref = JNetwork(os.path.join(root, "ref"), max_message_count=BLOCK_TXS,
                   batch_timeout="60s")
    nets = []
    try:
        raft = _raft_network(os.path.join(root, "raft"), _raft_material(ref),
                             gpu.GpuVerifier(device="cpu", buckets=(32,)))
        nets.append(raft)
        assert raft.consensus_type == "etcdraft"
        assert [o.id for o in raft.orderers] == list(IDS)
        leader = raft.raft_leader()
        follower = next(o for o in raft.orderers if o.id != leader)
        submits, expected = fixtures.make_e2e_stream(raft, n_tx,
                                                     plant_every=8)

        def feed():
            for env, ok in submits:
                try:
                    follower.broadcast.submit(env)
                    assert ok, "a tampered creator was accepted"
                except BroadcastError:
                    assert not ok
        assert e2e.commit_until(raft, n_tx, 300, feed=feed,
                                idle_timeout_s=300)[1] == n_tx
        flags = _flags(raft.ledger, protoutil)
        assert [f for b in flags for f in b] == expected
        assert raft.raft_leader() == leader          # no other election
        assert follower.support.chain.forwarded == n_tx

        # the three orderers hold the same chain (the peer delivers from
        # the first; the others may lag it by an apply)
        stores = [o.support.store for o in raft.orderers]
        deadline = time.monotonic() + 30
        while {s.height for s in stores} != {N_BLOCKS + 1} \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert {s.height for s in stores} == {N_BLOCKS + 1}
        for num in range(1, N_BLOCKS + 1):
            blocks = [s.get_block_by_number(num) for s in stores]
            assert len({protoutil.block_header_hash(b.header)
                        for b in blocks}) == 1
            assert len({bytes(b.metadata.metadata[3]) for b in blocks}) == 1
            assert len({bytes(b.metadata.metadata[0]) for b in blocks}) == 3

        # the solo networks of both packages, fed the Raft order
        ordered = [bytes(raw) for num in range(1, N_BLOCKS + 1)
                   for raw in raft.ledger.get_block_by_number(num).data.data]
        tampered = [env.encode() for env, ok in submits if not ok]
        solo = e2e.Network(os.path.join(root, "solo"),
                           material=convert.network_material_from_reference(
                               ref), verifier=sw.SwVerifier())
        nets.append(solo)
        for raw in ordered:
            solo.broadcast.submit(m.Envelope.decode(raw))
            ref.broadcast.submit(jm.Envelope.decode(raw))
        for raw in tampered:
            with pytest.raises(BroadcastError):
                solo.broadcast.submit(m.Envelope.decode(raw))
            with pytest.raises(JBroadcastError):
                ref.broadcast.submit(jm.Envelope.decode(raw))
        assert e2e.commit_until(solo, n_tx, 120)[1] == n_tx
        assert ref.pump_committed(n_tx, timeout=120) == n_tx
        assert _flags(solo.ledger, protoutil) == flags
        assert _flags(ref.ledger, jprotoutil) == flags
        for num in range(1, N_BLOCKS + 1):
            assert [bytes(d) for d in
                    solo.ledger.get_block_by_number(num).data.data] == \
                [bytes(d) for d in
                 ref.ledger.get_block_by_number(num).data.data] == \
                [bytes(d) for d in
                 raft.ledger.get_block_by_number(num).data.data]
        assert raft.ledger.state_fingerprint() == \
            solo.ledger.state_fingerprint() == \
            ref.ledger.state_fingerprint()
    finally:
        for net in nets:
            net.close()
        ref.close()


def test_raft_network_needs_a_signer_per_consenter(tmp_path):
    """An etcdraft genesis whose consenters lack signers is refused, and
    the partly built ordering service is stopped."""
    mat = fixtures.make_network_material(5, consensus_type="etcdraft",
                                         orderers=3)
    mat.consenters.pop("orderer2")
    with pytest.raises(ValueError, match="signer for each"):
        e2e.Network(str(tmp_path), material=mat, verifier=sw.SwVerifier())
