"""The port imports neither jax, nor any module of the JAX package, nor
the `cryptography`, `grpc` or `yaml` packages: a fresh interpreter imports every port module,
runs the CPU verify path, commits one small block through the port's
Committer on the CPU and two 16-tx blocks through the columnar decode
and the vectorized MVCC (host verifier), verifies one idemix
presentation on the host path, orders and commits one 8-tx block
through the port's e2e Network (with the host verifier: the GPU
verifier's CPU path ran above), one through a staged Network from 4
submitter threads and one through a Network of three Raft orderers (a
follower forwarding to the leader), pushes one ordered block through
three gossip peers that joined by signed alive messages, relays it down
a three-peer dissemination tree and serves one filtered frame of it
through a deliver FanoutEngine with a session ACL check, commits one
block on each of two channels through a 2-slice ChannelShardRouter
(GpuVerifier slices on the CPU), reopens three durable gossip peers'
ledgers, commits a private block whose plaintext one of them holds and
runs one reconcile_tick on another, deploys a chaincode by the lifecycle
ceremony, answers one rich query, snapshots the ledger and bootstraps a
second one from the snapshot, runs a traced pipeline (stage
attribution), an admission-armed Network that sheds, a follower that
joins and pulls its chain, a Network ordering through the broker
consenter with an operations server scraped beside it, a discovery
service's access check and layouts on it, and a ccaas package resolved
by the chaincode launcher and invoked over TCP, arms and disarms a fault
plan, retries through a Retrier, runs a two-event soak under churn
(host verifier), drives the offline tools through cli.main (cryptogen,
configtxgen, a configtxlator round trip, discover (no verifier), a
ledger snapshot) with one block committed by a tool-built Network under
armed guards, drives the transport (a unary call and a stream over
mutual TLS, a Raft Step between two cluster transports) and runs
`cli.main node` in a thread, then inspects sys.modules: no jax, no
module of the JAX package, no `cryptography`, `grpc` or `yaml`.  The
fault registry declares the transport's two points."""
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, os, pkgutil, sys
import torch
torch.set_num_threads(1)
import fabric_mod_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.utils import fixtures
items, expect = fixtures.make_block(0, n_tx=1, raw_endorsers=True,
                                    adversarial=False)
got = gpu.GpuVerifier(device="cpu").verify_many(items)
assert got.tolist() == expect.tolist(), (got, expect)
from fabric_mod_tpu_torch.protos import messages
world = fixtures.make_commit_world()
blocks, flags = fixtures.make_commit_blocks(world, 1, 2)
committer = world.committer(gpu.GpuVerifier(device="cpu"), tensor_policy=True)
assert committer.store_block(messages.Block.decode(blocks[0])) == flags[0]
assert committer.ledger.height == 1
from fabric_mod_tpu_torch.bccsp import sw
blocks, flags = fixtures.make_commit_blocks(world, 2, 16)
committer = world.committer(sw.SwVerifier())
for raw, want in zip(blocks, flags):
    assert committer.store_block(messages.Block.decode(raw)) == want
    assert committer.last_timings["body_fallbacks"] == 0
from fabric_mod_tpu_torch.idemix import credential
idemix = fixtures.make_idemix_world(seed=1, n_users=1)
pres, want = fixtures.make_presentations(idemix, 1)
assert credential.batch_verify(idemix.issuer.key, pres,
                               use_device=False) == want == [True]
import tempfile
from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.protos import protoutil
material = fixtures.make_network_material(2, max_message_count=8,
                                          batch_timeout="60s")
with tempfile.TemporaryDirectory() as root:
    net = e2e.Network(root, material=material, verifier=sw.SwVerifier())
    try:
        submits, want = fixtures.make_e2e_stream(net, 8, plant_every=8)
        for env, ok in submits:
            if ok:
                net.broadcast.submit(env)
        assert e2e.commit_until(net, 8, 120)[1] == 8
        block = net.ledger.get_block_by_number(1)
        assert list(protoutil.block_txflags(block)) == want
    finally:
        net.close()
    net = e2e.Network(root + "/staged", material=material,
                      verifier=sw.SwVerifier(), ingress_batching=True,
                      staged_batch=8)
    try:
        submits, want = fixtures.make_e2e_stream(net, 8, plant_every=8,
                                                 order_free=True)
        envs = [env for env, ok in submits if ok]
        assert e2e.commit_until(net, 8, 120, feed=lambda: e2e.submit_all(
            net, envs, submitters=4))[1] == 8
        block = net.ledger.get_block_by_number(1)
        got = {protoutil.envelope_channel_header(
            messages.Envelope.decode(raw)).tx_id: flag
            for raw, flag in zip(block.data.data,
                                 protoutil.block_txflags(block))}
        assert got == {protoutil.envelope_channel_header(env).tx_id: flag
                       for env, flag in zip(envs, want)}
    finally:
        net.close()
from fabric_mod_tpu_torch.orderer import raft, raftchain
material = fixtures.make_network_material(2, consensus_type="etcdraft",
                                          orderers=3, max_message_count=8,
                                          batch_timeout="60s")
with tempfile.TemporaryDirectory() as root:
    net = e2e.Network(root, material=material, verifier=sw.SwVerifier())
    try:
        assert isinstance(net.support.chain, raftchain.RaftChain)
        follower = next(o for o in net.orderers if o.id != net.raft_leader())
        submits, want = fixtures.make_e2e_stream(net, 8, plant_every=8)
        for env, ok in submits:
            if ok:
                follower.broadcast.submit(env)
        assert e2e.commit_until(net, 8, 120)[1] == 8
        block = net.ledger.get_block_by_number(1)
        assert list(protoutil.block_txflags(block)) == want
    finally:
        net.close()
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.gossip import GossipNode, InProcNetwork
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.peer.channel import Channel
material = fixtures.make_network_material(2, max_message_count=8,
                                          batch_timeout="60s", gossip_peers=3)
with tempfile.TemporaryDirectory() as root:
    net = e2e.Network(root + "/net", material=material,
                      verifier=sw.SwVerifier())
    try:
        submits, want = fixtures.make_e2e_stream(net, 8, plant_every=8)
        for env, ok in submits:
            if ok:
                net.broadcast.submit(env)
        assert e2e.commit_until(net, 8, 120)[1] == 8
        block = net.support.store.get_block_by_number(1)
    finally:
        net.close()
    fabric, nodes, mgrs = InProcNetwork(), [], []
    for i, pems in enumerate(material.gossip_peers):
        genesis = messages.Block.decode(material.genesis)
        cid, config = config_from_block(genesis)
        mgrs.append(LedgerManager(f"{root}/gossip{i}"))
        channel = Channel(cid, mgrs[-1].create_or_open(cid), sw.SwVerifier(),
                          Bundle(cid, config, sw.SwCSP()), sw.SwCSP())
        channel.init_from_genesis(genesis)
        nodes.append(GossipNode(f"gossip{i}:7051", e2e._signer(
            sw.SwCSP(), pems), channel, fabric))
    for node in nodes:
        node.join([n.endpoint for n in nodes])
    assert nodes[0].state.add_block(block) and nodes[0].state.drain() == 1
    nodes[0].gossip_block(block)
    for node in nodes:
        node.state.drain()
    for node, mgr in zip(nodes, mgrs):
        assert node._channel.ledger.height == 2
        assert list(protoutil.block_txflags(
            node._channel.ledger.get_block_by_number(1))) == want
        assert node.state.errors == []
        node.stop()
        mgr.close()
import time
from fabric_mod_tpu_torch.dissemination import RelayService
from fabric_mod_tpu_torch.peer.aclmgmt import ACLProvider
from fabric_mod_tpu_torch.peer.fanout import FanoutEngine, encode_frame
with tempfile.TemporaryDirectory() as root:
    fabric, nodes, mgrs, relays = InProcNetwork(), [], [], []
    for i, pems in enumerate(material.gossip_peers):
        genesis = messages.Block.decode(material.genesis)
        cid, config = config_from_block(genesis)
        mgrs.append(LedgerManager(f"{root}/relay{i}"))
        channel = Channel(cid, mgrs[-1].create_or_open(cid), sw.SwVerifier(),
                          Bundle(cid, config, sw.SwCSP()), sw.SwCSP())
        channel.init_from_genesis(genesis)
        nodes.append(GossipNode(f"relay{i}:7051", e2e._signer(
            sw.SwCSP(), pems), channel, fabric))
    for node in nodes:
        node.join([n.endpoint for n in nodes])
    relays = [RelayService(node, degree=1) for node in nodes]
    lead = min(range(3), key=lambda i: (nodes[i].pki_id, nodes[i].endpoint))
    assert max(relays[lead].tree().depth(n.endpoint) for n in nodes) == 2
    for relay in relays:
        relay.start()
    relays[lead].on_leadership(True)
    assert nodes[lead].state.add_block(block) and nodes[lead].state.drain() == 1
    relays[lead].on_leader_commit(block)
    deadline = time.monotonic() + 120
    while min(n._channel.ledger.height for n in nodes) < 2:
        assert time.monotonic() < deadline
        for node in nodes:
            node.state.drain()
        time.sleep(0.01)
    ledger = nodes[lead]._channel.ledger
    for node, relay in zip(nodes, relays):
        relay.stop()
        assert relay.errors == [] and node.state.errors == []
        assert list(protoutil.block_txflags(
            node._channel.ledger.get_block_by_number(1))) == want
    assert sum(r.stats["forwarded"] for r in relays) == 2
    client = e2e._signer(sw.SwCSP(), material.client)
    engine = FanoutEngine(cid, ledger, ACLProvider(
        nodes[lead]._channel.bundle, sw.SwVerifier().verify_many))
    engine.attach("filtered")
    frame = engine.get_frame("filtered", 1)
    assert frame.payload == encode_frame(
        cid, "filtered", ledger.get_block_by_number(1), batch=False)
    session = engine.acl_groups.join(
        "event/FilteredBlock", protoutil.SignedData(
            data=b"seek", identity=client.serialize(),
            signature=client.sign_message(b"seek")), 0)
    session.recheck(force=True, config_mark=1)
    assert engine.acl_groups.stats["checks"] == 1
    engine.close()
    for node, mgr in zip(nodes, mgrs):
        node.stop()
        mgr.close()
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.peer.commitpipe import ValidatorCommitTarget
from fabric_mod_tpu_torch.peer.txvalidator import TxValidator, ValidationInfoProvider
from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
from fabric_mod_tpu_torch.sharding import ChannelShardRouter
router = ChannelShardRouter(n_slices=2, verifier_factory=lambda i, mesh:
                            gpu.GpuVerifier(device="cpu", cache_size=0))
targets = {}
try:
    for cid in ("sh0", "sh1"):
        led = KvLedger(cid)
        targets[cid] = ValidatorCommitTarget(TxValidator(
            cid, world.mgr, ApplicationPolicyEvaluator(world.mgr),
            router.add_channel(cid), ValidationInfoProvider(world.policy),
            tx_id_exists=led.tx_id_exists), led)
        router.bind_target(cid, targets[cid])
        raw = fixtures.make_channel_stream(world.signers, cid, 1, 4)[0]
        router.submit_block(cid, messages.Block.decode(raw))
    assert router.flush(120)
finally:
    router.close()
for cid, t in targets.items():
    assert router.slice_of(cid) == int(cid[-1])
    assert list(protoutil.block_txflags(t.ledger.get_block_by_number(0))) == [
        0, 0, 0, messages.TxValidationCode.ENDORSEMENT_POLICY_FAILURE]
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.gossip import GossipNode, InProcNetwork
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.peer.channel import Channel
pmat = fixtures.make_network_material(3, gossip_peers=3)
pgen = messages.Block.decode(pmat.genesis)
pblocks, plain, pkeys = fixtures.make_pvt_blocks(
    fixtures.network_world(pmat), 1, 10, first_block=1,
    prev_hash=protoutil.block_header_hash(pgen.header))
pcid, pconfig = config_from_block(pgen)

def pvt_peers(root, fabric):
    out = []
    for i, (mspid, cert_pem, key_pem) in enumerate(pmat.gossip_peers):
        csp = sw.SwCSP()
        mgr = LedgerManager(os.path.join(root, f"pvt{i}"))
        ch = Channel(pcid, mgr.create_or_open(pcid), sw.SwVerifier(),
                     Bundle(pcid, pconfig, csp), csp)
        if ch.ledger.height == 0:
            ch.init_from_genesis(pgen)
        out.append((mgr, ch, GossipNode(f"pvt{i}:7051", e2e._signer(
            csp, (mspid, cert_pem, key_pem)), ch, fabric)))
    for _mgr, _ch, node in out:
        node.join([n.endpoint for _m, _c, n in out])
    return out

with tempfile.TemporaryDirectory() as root:
    peers = pvt_peers(root, InProcNetwork())
    for mgr, ch, node in peers:
        ch.store_block(messages.Block.decode(pblocks[0]))
        node.stop()
        mgr.close()
    peers = pvt_peers(root, InProcNetwork())
    assert [ch.ledger.replayed_blocks for _m, ch, _n in peers] == [0, 0, 0]
    for txid, pvt in plain.items():
        peers[0][1].transient_store.persist(txid, 0, pvt)
    for _mgr, ch, _node in peers:
        assert set(ch.store_block(messages.Block.decode(pblocks[1]))) == {0}
    assert peers[1][2].reconcile_tick() == len(plain) == 1
    qe = peers[1][1].ledger.new_query_executor()
    for key, value in pkeys.values():
        assert qe.get_private_data("mycc", "col1", key) == value
    for mgr, _ch, node in peers:
        node.stop()
        mgr.close()
from fabric_mod_tpu_torch.ledger.snapshot import (bootstrap_from_snapshot,
                                                  verify_snapshot)
lmat = fixtures.make_network_material(4, max_message_count=8,
                                      batch_timeout="100ms")
with tempfile.TemporaryDirectory() as root:
    net = e2e.Network(os.path.join(root, "lc"), material=lmat,
                      verifier=sw.SwVerifier())
    try:
        assert net.deploy_chaincode("cc2", "1.0", 1) == 3
        net.invoke([b"put", b"d1", b'{"owner": "alice"}'])
        assert net.pump_committed(4) == 4
        sp, _prop, _t = protoutil.create_chaincode_proposal(
            net.channel_id, "mycc",
            [b"query", b'{"selector": {"owner": "alice"}}'], net.client)
        resp = net.endorsers["Org1"].process_proposal(sp)
        assert json.loads(resp.response.payload)["results"][0]["key"] == "d1"
        meta = net.ledger.snapshot_to(os.path.join(root, "snap"))
        assert verify_snapshot(os.path.join(root, "snap")) == meta
        joined = bootstrap_from_snapshot(os.path.join(root, "snap"),
                                         os.path.join(root, "joined"))
        assert joined.state_fingerprint() == net.ledger.state_fingerprint()
        joined.close()
    finally:
        net.close()
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.orderer import admission
from fabric_mod_tpu_torch.orderer.participation import ChannelParticipation
from fabric_mod_tpu_torch.orderer.registrar import Registrar
import time
stats = {}
with tracing.active():
    assert e2e.run_pipeline(8, verifier=sw.SwVerifier(), stats=stats) > 0
assert stats["stage_attribution"]["verdict_await"] > 0
amat = fixtures.make_network_material(5, max_message_count=8,
                                      batch_timeout="60s")
with tempfile.TemporaryDirectory() as root:
    net = e2e.Network(os.path.join(root, "adm"), material=amat,
                      verifier=sw.SwVerifier(),
                      admission={"queue_cap": 4, "rate": 1.0, "burst": 2.0})
    try:
        submits, _want = fixtures.make_e2e_stream(net, 8)
        shed = 0
        for env, ok in submits:
            try:
                if ok:
                    net.broadcast.submit(env)
            except admission.ResourceExhaustedError:
                shed += 1
        assert shed > 0 and net.support.chain.submit_queue_depth()[1] == 4
        reg = Registrar(os.path.join(root, "follower"),
                        e2e._signer(net.csp, amat.orderer), net.csp)
        store = net.support.store
        fetch = lambda lo, hi: [store.get_block_by_number(i)
                                for i in range(lo, hi or store.height)]
        joined = ChannelParticipation(reg, block_fetcher=fetch).join(
            net.genesis_block, as_follower=True)
        deadline = time.time() + 30
        while joined.store.height < store.height and time.time() < deadline:
            time.sleep(0.05)
        assert joined.store.height == store.height
        reg.close()
    finally:
        net.close()
import json as _json
import urllib.request
from fabric_mod_tpu_torch.discovery import DiscoveryService
from fabric_mod_tpu_torch.observability import OperationsServer
from fabric_mod_tpu_torch.orderer.broker import Broker, BrokerChain
from fabric_mod_tpu_torch.peer.ccpackage import PackageStore, build_package
from fabric_mod_tpu_torch.peer.chaincode import (ChaincodeError,
                                                 ChaincodeStub, KvContract)
from fabric_mod_tpu_torch.peer.extbuilder import (ChaincodeLauncher,
                                                  ChaincodeServer)
kmat = fixtures.make_network_material(6, consensus_type="kafka",
                                      max_message_count=4,
                                      batch_timeout="100ms")
with tempfile.TemporaryDirectory() as root:
    broker = Broker(os.path.join(root, "broker"))
    net = e2e.Network(os.path.join(root, "kafka"), material=kmat,
                      verifier=sw.SwVerifier(), consenters={
                          "kafka": lambda sup: BrokerChain(broker, sup)})
    ops = OperationsServer()
    ops.start()
    try:
        assert isinstance(net.support.chain, BrokerChain)
        submits, want = fixtures.make_e2e_stream(net, 8, plant_every=8)
        for env, ok in submits:
            if ok:
                net.broadcast.submit(env)
        assert e2e.commit_until(net, 8, 120)[1] == 8
        flags = [f for n in range(1, net.ledger.height)
                 for f in protoutil.block_txflags(
                     net.ledger.get_block_by_number(n))]
        assert flags == want
        base = "http://%s:%d" % ops.addr
        assert b"fabric_commitpipe_blocks_total" in \
            urllib.request.urlopen(base + "/metrics").read()
        assert _json.load(urllib.request.urlopen(base + "/healthz"))[
            "status"] == "OK"
        svc = DiscoveryService(net.channel.bundle, net.channel._vinfo,
                               lambda: {},
                               verify_many=sw.SwVerifier().verify_many)
        data = b"discovery-query"
        assert svc.check_access(protoutil.SignedData(
            data=data, identity=net.client.serialize(),
            signature=net.client.sign_message(data)))
        assert len(svc.peers_for_endorsement("mycc").layouts) == 3
    finally:
        ops.stop()
        net.close()
        broker.close()
    srv = ChaincodeServer(KvContract())
    srv.start()
    store = PackageStore(os.path.join(root, "pkgs"))
    store.save(build_package("remote", _json.dumps(
        {"address": srv.address}).encode(), cc_type="ccaas"))
    launcher = ChaincodeLauncher(store)
    cc = launcher.resolve("remote")
    try:
        cc.invoke(ChaincodeStub("remote", None, [b"nosuch"], "t", "ch"))
        raise AssertionError("the remote contract answered an unknown op")
    except ChaincodeError as e:
        assert "unknown op" in str(e), e
    finally:
        cc.close()
        launcher.close()
        srv.stop()
from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.soak import SoakConfig, SoakHarness
from fabric_mod_tpu_torch.utils.retry import Retrier
plan = faults.FaultPlan.parse("peer.mvcc.vector:error@n=1").validate()
faults.arm(plan)
try:
    faults.point("peer.mvcc.vector")
    raise AssertionError("the armed rule did not fire")
except faults.InjectedFault:
    pass
finally:
    faults.disarm()
assert not faults.armed() and plan.fires() == 1
tries = []

def flaky():
    tries.append(1)
    if len(tries) < 3:
        raise OSError("transient")
    return len(tries)

assert Retrier(base_s=0.0, jitter=0.0, max_attempts=3,
               sleep=lambda s: None).call(flaky) == 3
rep = SoakHarness(SoakConfig(seed=11, n_events=2, n_channels=1, n_peers=2,
                             gap_txs=(2, 3), verifier=sw.SwVerifier())).run()
assert rep["x509_txs"] > 0 and rep["audited_txs"] == rep["x509_txs"]
assert len(rep["events"]) == 2 and rep["fault_fires"] > 0
import contextlib, io, os, tempfile
from fabric_mod_tpu_torch import concurrency, e2e as _e2e
from fabric_mod_tpu_torch.cli import cryptogen as _cg
from fabric_mod_tpu_torch.cli.main import main as cli
with tempfile.TemporaryDirectory() as d, \
        contextlib.redirect_stdout(io.StringIO()):
    with open(f"{d}/c.yaml", "w") as f:
        f.write("PeerOrgs:\n  - Name: Org1\n  - Name: Org2\n"
                "  - Name: Org3\nOrdererOrgs:\n  - Name: OrdererOrg\n")
    with open(f"{d}/p.yaml", "w") as f:
        f.write("ChannelID: auditchan\nPeerOrgs: [Org1, Org2, Org3]\n"
                "OrdererOrgs: [OrdererOrg]\nBatchSize:\n"
                "  MaxMessageCount: 8\nBatchTimeout: 5s\n")
    assert cli(["cryptogen", "--config", f"{d}/c.yaml", "--output",
                f"{d}/crypto"]) == 0
    assert cli(["configtxgen", "--profile", f"{d}/p.yaml", "--crypto",
                f"{d}/crypto", "--output", f"{d}/g.block"]) == 0
    js = io.StringIO()
    with contextlib.redirect_stdout(js):
        assert cli(["configtxlator", "proto_decode", "--type", "Block",
                    "--input", f"{d}/g.block"]) == 0
    with open(f"{d}/g.json", "w") as f:
        f.write(js.getvalue())
    assert cli(["configtxlator", "proto_encode", "--type", "Block",
                "--input", f"{d}/g.json", "--output", f"{d}/g2.block"]) == 0
    assert open(f"{d}/g2.block", "rb").read() == \
        open(f"{d}/g.block", "rb").read()
    assert cli(["discover", "endorsers", "--genesis", f"{d}/g.block",
                "--chaincode", "mycc"]) == 0
    mat = _cg.network_material(f"{d}/crypto", open(f"{d}/g.block", "rb").read())
    with concurrency.armed():
        net = _e2e.Network(f"{d}/net", mat, verifier=sw.SwVerifier())
        try:
            for i in range(8):
                net.invoke([b"put", b"audit%d" % i, b"v"])
            assert _e2e.commit_until(net, 8, 60)[1] == 8
        finally:
            net.close()
    assert cli(["ledger", "snapshot", "--ledger",
                f"{d}/net/peer/auditchan", "--channel", "auditchan",
                "--output", f"{d}/snap"]) == 0
    # the transport: a unary call and a stream over mutual TLS, a Raft
    # Step between two cluster transports, then `cli.main node` (the
    # combined role, host verifier) in a thread, stopped by its event
    import threading, time
    from fabric_mod_tpu_torch.cli import node as _node
    from fabric_mod_tpu_torch.comm.grpc_comm import (GRPCClient, GRPCServer,
                                                     MethodKind)
    from fabric_mod_tpu_torch.comm.tls import TlsCA
    from fabric_mod_tpu_torch.orderer import cluster as _cluster
    from fabric_mod_tpu_torch.orderer import raft as _raft
    tca = TlsCA(seed=b"audit")
    sc, sk = tca.issue("audit.example.com", sans=("127.0.0.1",))
    cc, ck = tca.issue("audit.client", server=False)
    srv = GRPCServer("127.0.0.1:0", sc, sk, tca.cert_pem)
    srv.register("audit.Svc", "Echo", MethodKind.UNARY, lambda r, c: r)
    srv.register("audit.Svc", "Pipe", MethodKind.STREAM_STREAM,
                 lambda it, c: (x[::-1] for x in it))
    srv.start()
    rpc = GRPCClient(f"127.0.0.1:{srv.port}", tca.cert_pem, cc, ck)
    assert rpc.unary("audit.Svc", "Echo", b"u") == b"u"
    assert list(rpc.stream_stream("audit.Svc", "Pipe",
                                  iter([b"ab", b"cd"]))) == [b"ba", b"dc"]
    rpc.close()
    srv.stop()
    steps = []
    trs = {n: _cluster.GRPCRaftTransport(
        n, {"n1": "127.0.0.1:0", "n2": "127.0.0.1:0"},
        listen_address="127.0.0.1:0", server_cert=sc, server_key=sk,
        client_ca=tca.cert_pem, client_cert=cc, client_key=ck)
        for n in ("n1", "n2")}
    for n, tr in trs.items():
        for m_, other in trs.items():
            tr.set_peer_address(m_, f"127.0.0.1:{other.listen_port}")
        tr.start()
    trs["n1"].register("n1", lambda src, msg: steps.append((src, msg.term)))
    trs["n2"].send("n2", "n1", _raft.RequestVote(7, "n2", 0, 0))
    deadline = time.monotonic() + 30
    while not steps:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert steps == [("n2", 7)]
    for tr in trs.values():
        tr.stop()
    with open(f"{d}/core.yaml", "w") as f:
        f.write("peer:\n  BCCSP:\n    Default: SW\n")
    stop = threading.Event()
    runner = threading.Thread(target=_node.main, args=([
        "--role", "combined", "--genesis", f"{d}/g.block", "--crypto",
        f"{d}/crypto", "--data", f"{d}/node", "--config",
        f"{d}/core.yaml"],), kwargs={"stop_event": stop})
    runner.start()
    deadline = time.monotonic() + 60
    while not os.path.isdir(f"{d}/node/data/ledgers/auditchan"):
        assert time.monotonic() < deadline and runner.is_alive()
        time.sleep(0.05)
    stop.set()
    runner.join(60)
    assert not runner.is_alive()
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "fabric_mod_tpu" or n.startswith("fabric_mod_tpu.")
             or n == "cryptography" or n.startswith("cryptography.")
             or n == "grpc" or n.startswith("grpc.")
             or n == "yaml" or n.startswith("yaml."))
print(json.dumps(bad))
"""


def test_port_loads_no_jax_and_no_reference_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_fault_registry_declares_the_transports_points():
    from fabric_mod_tpu_torch.faults import points
    assert {"deliver.failover.stream", "gossip.comm.send"} <= \
        points.DECLARED_POINTS
