"""Raft over the port's cluster transport (fabric_mod_tpu_torch/orderer/
cluster.py) against the reference's (fabric_mod_tpu/orderer/cluster.py,
over grpcio).

- The codec: `encode_msg` gives the reference's bytes for every Raft
  message type and the forwarded submit, and each side decodes the
  other's bytes to equal fields.
- Three port orderers on loopback with mutual TLS, each a Registrar
  whose RaftChain speaks `Cluster/Step` through a GRPCRaftTransport:
  one leader elected over the wire (wall clock), eight submits through
  a follower ordered into identical chains; then, on a shared
  ManualClock, a leader's transport and registrar stopped, a new leader
  elected among the two survivors, which keep ordering.
- A dialer whose client certificate comes from a stranger CA is refused
  at the TLS handshake.
"""
import random
import time

import pytest
from fabric_mod_tpu.orderer import cluster as jcluster
from fabric_mod_tpu.orderer import raft as jraft
from fabric_mod_tpu.orderer import raftchain as jraftchain

from tests._clocksteps import advance_until, leader_known_by_all

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import genesis
from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient, RpcError
from fabric_mod_tpu_torch.comm.tls import TlsCA
from fabric_mod_tpu_torch.concurrency import live_registered
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.msp.identities import SigningIdentity
from fabric_mod_tpu_torch.orderer import raft, raftchain
from fabric_mod_tpu_torch.orderer.cluster import (GRPCRaftTransport,
                                                  decode_msg, encode_msg)
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

IDS = ["g0", "g1", "g2"]


def _pairs():
    """Each message kind as (port message, reference message)."""
    entries = [(3, b"blockdata"), (4, b"\x00\xffx")]
    kinds = [
        ("RequestVote", (3, "o1", 7, 2)),
        ("VoteReply", (3, "o2", True)),
        ("AppendEntries", (4, "o0", 5, 3, entries, 5)),
        ("AppendEntries", (4, "o0", 5, 3, [], 5)),
        ("AppendReply", (4, "o1", False, 9)),
        ("InstallSnapshot", (6, "o0", 40, 5, b"\x01snapshot")),
    ]
    out = [(getattr(raft, k)(*a), getattr(jraft, k)(*a)) for k, a in kinds]
    out.append((raftchain._Submit(b"\x0aenvelope", True, 2),
                jraftchain._Submit(b"\x0aenvelope", True, 2)))
    return out


def _fields(msg):
    return {s: getattr(msg, s) for s in type(msg).__slots__}


@pytest.mark.parametrize("idx", range(7))
def test_codec_bytes_equal_the_references(idx):
    mine, ref = _pairs()[idx]
    raw = encode_msg(mine)
    assert raw == jcluster.encode_msg(ref)
    back = decode_msg(jcluster.encode_msg(ref))
    assert type(back) is type(mine) and _fields(back) == _fields(mine)
    jback = jcluster.decode_msg(raw)
    assert type(jback).__name__ == type(mine).__name__
    assert _fields(jback) == _fields(mine)


def test_codec_refuses_unknown_kinds():
    with pytest.raises(TypeError):
        encode_msg(object())
    with pytest.raises(ValueError):
        decode_msg(b'{"t": "zz"}')


@pytest.fixture()
def make_cluster(tmp_path):
    """Factory: three port orderers over GRPCRaftTransports with mutual
    TLS, wall-clock (clock=None) or on a shared ManualClock."""
    worlds = []

    def make(clock=None):
        tls = TlsCA(seed=b"cluster-tls")
        csp = SwCSP()
        org_ca = calib.CA("ca.org1", "Org1", seed=b"cluster")
        ord_ca = calib.CA("ca.o", "OrdererOrg", seed=b"cluster")
        blk = genesis.standard_network(
            "gchan", {"Org1": [calib.cert_pem(org_ca.cert)]},
            {"OrdererOrg": [calib.cert_pem(ord_ca.cert)]},
            consensus_type="etcdraft", batch_timeout="200ms",
            max_message_count=3)
        transports = {}
        for i in IDS:
            scert, skey = tls.issue(f"{i}.cluster",
                                    sans=("localhost", "127.0.0.1"))
            ccert, ckey = tls.issue(f"{i}.client")
            transports[i] = GRPCRaftTransport(
                i, {j: "127.0.0.1:0" for j in IDS},
                listen_address="127.0.0.1:0",
                server_cert=scert, server_key=skey, client_ca=tls.cert_pem,
                client_cert=ccert, client_key=ckey)
        for i in IDS:
            for j in IDS:
                transports[i].set_peer_address(
                    j, f"127.0.0.1:{transports[j].listen_port}")
            transports[i].start()
        registrars = {}
        for idx, i in enumerate(IDS):
            oc, ok = ord_ca.issue(f"{i}.o", "OrdererOrg", ous=["orderer"])
            signer = SigningIdentity("OrdererOrg", oc, calib.key_pem(ok),
                                     csp)

            def factory(support, i=i, idx=idx):
                return raftchain.RaftChain(
                    i, IDS, transports[i], str(tmp_path / f"{i}.wal"),
                    support, election_timeout=(0.3, 0.6), heartbeat_s=0.1,
                    clock=clock,
                    rng=random.Random(idx + 1) if clock else None)
            reg = Registrar(str(tmp_path / i), signer, csp,
                            chain_factory=factory)
            reg.create_channel(blk)
            registrars[i] = reg
        world = {"transports": transports, "registrars": registrars,
                 "csp": csp, "org_ca": org_ca, "tls": tls, "clock": clock,
                 "supports": {i: registrars[i].get_chain("gchan")
                              for i in IDS}}
        worlds.append(world)
        return world

    before = set(live_registered())
    yield make
    for world in worlds:
        for reg in world["registrars"].values():
            reg.close()
        for tr in world["transports"].values():
            tr.stop()
    left = [t.name for t in live_registered() if t not in before
            and t.structure in ("orderer.cluster", "comm.grpc_comm")
            and "rpc-send" not in t.name]
    assert left == []


def _wait(pred, t=30.0):
    deadline = time.time() + t
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _env(world, k):
    if "client" not in world:
        cc, ck = world["org_ca"].issue("cli@org1", "Org1", ous=["client"])
        world["client"] = SigningIdentity("Org1", cc, calib.key_pem(ck),
                                          world["csp"])
    b = RWSetBuilder()
    b.add_write("cc", f"k{k}", b"v")
    return protoutil.create_signed_tx(
        "gchan", "cc", b.build().encode(), world["client"],
        [world["client"]])


def _txs(support):
    return sum(len(support.store.get_block_by_number(n).data.data)
               for n in range(1, support.store.height))


def test_three_orderers_elect_and_order_identical_chains(make_cluster):
    world = make_cluster(None)
    sup = world["supports"]
    chains = {i: s.chain for i, s in sup.items()}
    assert _wait(lambda: leader_known_by_all(chains)), "no leader"
    follower = next(i for i, c in chains.items() if not c.is_leader)
    for k in range(8):                    # through a follower
        sup[follower].chain.order(_env(world, k), 0)
    assert _wait(lambda: all(_txs(s) == 8 for s in sup.values())), \
        {i: s.store.height for i, s in sup.items()}
    for n in range(1, sup[follower].store.height):
        hashes = {protoutil.block_header_hash(
            s.store.get_block_by_number(n).header) for s in sup.values()}
        assert len(hashes) == 1, f"divergence at {n}"


def test_survives_a_leader_stop(make_cluster):
    world = make_cluster(ManualClock())
    clock = world["clock"]
    sup = world["supports"]
    chains = {i: s.chain for i, s in sup.items()}

    def step(pred):
        return advance_until(clock, pred, step=0.05, max_steps=150,
                             settle_timeout=0.25, settle_poll=0.05)
    assert step(lambda: leader_known_by_all(chains))
    leader = next(i for i, c in chains.items() if c.is_leader)
    for k in range(3):
        sup[leader].chain.order(_env(world, k), 0)
    assert _wait(lambda: all(_txs(s) == 3 for s in sup.values()))
    world["transports"][leader].stop()
    world["registrars"][leader].close()
    rest = {i: c for i, c in chains.items() if i != leader}
    assert step(lambda: leader_known_by_all(rest)), "no re-election"
    survivor = next(i for i, c in rest.items() if c.is_leader)
    for k in range(3, 6):
        sup[survivor].chain.order(_env(world, k), 0)
    assert _wait(lambda: all(_txs(sup[i]) == 6 for i in rest))


def test_unauthenticated_dialer_refused(make_cluster):
    world = make_cluster(None)
    target = world["transports"]["g0"]
    stranger = TlsCA(name="stranger", seed=b"stranger")
    ccert, ckey = stranger.issue("intruder")
    intruder = GRPCClient(f"127.0.0.1:{target.listen_port}",
                          server_root_pem=world["tls"].cert_pem,
                          client_cert_pem=ccert, client_key_pem=ckey)
    with pytest.raises(RpcError) as got:
        intruder.unary("Cluster", "Step", b"{}", timeout=3.0)
    assert got.value.code().name == "UNAVAILABLE"
    intruder.close()
