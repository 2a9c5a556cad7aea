"""The port's process network: real OS processes, the Raft leader
killed (the reference's tests/test_procnet.py on the port).

Three Raft orderers and two peers, each `python -m
fabric_mod_tpu_torch.cli.main node` in its own process, with the tools'
crypto and genesis, mutual TLS between the orderers and TLS to them
(fabric_mod_tpu_torch/utils/procnet.py); the peers verify with `peer.BCCSP.Default:
SW` from their core.yaml (the test runs on the host).  Transactions go
through a follower, then the leader is SIGKILLed; a survivor is
elected, more transactions are ordered, and both peers commit through
deliver failover to equal heights and equal chains.  Each peer's blocks,
read back over the wire through qscc `GetBlockByNumber`, go through the
reference's validator and KvLedger (fabric_mod_tpu/peer/channel.py, on
the same genesis block): its txflags must equal the flags each peer
committed, and its state fingerprint each peer's own ledger's, which
are equal.  `chaincode invoke --wait-event` and `chaincode query` work
across the processes.
"""
import contextlib
import io
import os

import pytest

from fabric_mod_tpu_torch.cli.chaincode import _load_identity
from fabric_mod_tpu_torch.cli.main import main as cli
from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.peer.grpcdeliver import GrpcBroadcaster
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import procnet as pn


@pytest.fixture()
def procnet(tmp_path):
    net = pn.ProcNet(tmp_path, bccsp="SW")
    net.start_all()
    yield net
    net.teardown()


def _logs(net):
    return "\n".join(f"--- {name}\n{net.log_text(name)[-3000:]}"
                     for name in net.procs)


def _submit(net, oid, start, count):
    """`count` puts endorsed by both orgs' peers, broadcast to `oid`."""
    client_id = _load_identity(net.crypto_dir, "Org1", "users", "user0")
    endorsers = [_load_identity(net.crypto_dir, org, "peers", "peer0")
                 for org in ("Org1", "Org2")]
    conn = GRPCClient(f"127.0.0.1:{net.bports[oid]}",
                      server_root_pem=net.tls.cert_pem)
    bcast = GrpcBroadcaster(conn)
    try:
        for i in range(start, start + count):
            b = RWSetBuilder()
            b.add_write("mycc", f"pk{i}", b"pv%d" % i)
            bcast.submit(protoutil.create_signed_tx(
                net.channel, "mycc", b.build().encode(), client_id,
                endorsers))
    finally:
        bcast.close()
        conn.close()


def test_process_network_survives_leader_kill(procnet):
    net = procnet
    peers = ("p0", "p1")
    assert pn.wait(lambda: all(net.channel_info(o)["height"] >= 1
                               for o in net.o_ids), t=150), _logs(net)
    assert pn.wait(net.leader_known_by_all, t=150), _logs(net)
    assert pn.wait(lambda: all(net.peer_height(p) >= 1 for p in peers),
                   t=150), _logs(net)

    leader = net.leader()
    follower = next(o for o in net.o_ids if o != leader)
    _submit(net, follower, 0, 6)          # 6 txs, 5 a block: 2 blocks
    assert pn.wait(lambda: all(net.peer_height(p) >= 3 for p in peers),
                   t=150), _logs(net)

    leader = net.leader()
    net.kill(leader)
    survivors = [o for o in net.o_ids if o != leader]
    assert pn.wait(lambda: net.leader() in survivors, t=240), _logs(net)
    h0 = max(net.peer_height(p) for p in peers)
    _submit(net, net.leader(), 6, 6)
    assert pn.wait(lambda: all(net.peer_height(p) >= h0 + 1
                               for p in peers), t=240), _logs(net)
    # all 12 txs committed (a batch's last block is cut by its timeout)
    assert pn.wait(lambda: all(_committed(net, p) == 12 for p in peers),
                   t=60), _logs(net)
    assert pn.wait(lambda: len({net.peer_height(p) for p in peers}) == 1,
                   t=60), _logs(net)
    assert pn.wait(lambda: len({net.channel_info(o)["height"]
                                for o in survivors}) == 1, t=90)
    # one chain at both peers: every block's header hash alike
    tips = {}
    for p in peers:
        rc, out = _query(net, p, "qscc", "GetChainInfo")
        assert rc == 0, out
        tips[p] = out
    assert len(set(tips.values())) == 1
    height = net.peer_height(peers[0])
    blocks = {p: [_block(net, p, n) for n in range(height)] for p in peers}
    assert blocks[peers[0]] == blocks[peers[1]]

    # held to the reference: its validator's flags over the same blocks
    # are the ones the peers committed, and its state is theirs
    want_flags, want_fp = _reference_replay(net, net.root + "/ref",
                                            blocks[peers[0]])
    net.teardown()
    fps = {}
    for p in peers:
        mgr = LedgerManager(os.path.join(net.root, "data", p, "ledgers"))
        try:
            led = mgr.create_or_open(net.channel)
            assert led.height == height
            assert [led.get_block_by_number(n).encode()
                    for n in range(height)] == blocks[p]
            assert [list(protoutil.block_txflags(led.get_block_by_number(n)))
                    for n in range(1, height)] == want_flags
            fps[p] = led.state_fingerprint()
        finally:
            mgr.close()
    assert fps == {p: want_fp for p in peers}
    assert sum(f.count(m.TxValidationCode.VALID) for f in want_flags) == 12


def _query(net, peer, name, args):
    rc, raw = _query_bytes(net, peer, name, args)
    return rc, raw.decode()


def _query_bytes(net, peer, name, args):
    """`chaincode query` at `peer`: (exit code, the payload's bytes)."""
    out = io.StringIO()
    out.buffer = io.BytesIO()
    argv = net.cc_args("query", args, peers=(peer,), name=name)
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.buffer.getvalue()


def _block(net, peer, n):
    """Block `n` of `peer`'s ledger through qscc, encoded."""
    rc, raw = _query_bytes(net, peer, "qscc", f"GetBlockByNumber,{n}")
    assert rc == 0, raw
    return raw


def _committed(net, peer):
    """The txs in `peer`'s blocks after genesis, read through qscc."""
    return sum(len(m.Block.decode(_block(net, peer, n)).data.data)
               for n in range(1, net.peer_height(peer)))


def _reference_replay(net, root, blocks):
    """The reference's channel on the network's genesis block validates
    and commits `blocks` (encoded, from block 1 on) as an orderer would
    deliver them, without txflags: (each block's flags, the state
    fingerprint)."""
    from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.channelconfig import Bundle as JBundle
    from fabric_mod_tpu.channelconfig.configtx import \
        config_from_block as j_cfb
    from fabric_mod_tpu.ledger.kvledger import KvLedger as JKvLedger
    from fabric_mod_tpu.peer.channel import Channel as JChannel
    from fabric_mod_tpu.protos import messages as jm
    from fabric_mod_tpu.protos import protoutil as jprotoutil
    with open(net.genesis, "rb") as f:
        genesis = jm.Block.decode(f.read())
    cid, config = j_cfb(genesis)
    csp = JSwCSP()
    ledger = JKvLedger(root, cid, durable=False)
    try:
        chan = JChannel(cid, ledger, FakeBatchVerifier(csp),
                        JBundle(cid, config, csp), csp)
        chan.init_from_genesis(genesis)
        flags = []
        for raw in blocks[1:]:
            blk = jm.Block.decode(raw)
            jprotoutil.set_block_txflags(blk, b"")
            flags.append(list(chan.store_block(blk)))
        return flags, ledger.state_fingerprint()
    finally:
        ledger.close()


def test_chaincode_cli_invoke_and_query_across_processes(procnet):
    net = procnet
    assert pn.wait(net.leader_known_by_all, t=150), _logs(net)
    assert pn.wait(lambda: all(net.peer_height(p) >= 1
                               for p in ("p0", "p1")), t=150), _logs(net)
    assert cli(net.cc_args("invoke", "put,clikey,clivalue")) == 0
    assert pn.wait(lambda: all(net.peer_height(p) >= 2
                               for p in ("p0", "p1")), t=150), _logs(net)
    assert cli(net.cc_args("invoke", "put,evkey,evvalue",
                           extra=["--wait-event", "--wait-timeout",
                                  "60"])) == 0
    for p in ("p0", "p1"):
        assert _query(net, p, "mycc", "get,clikey") == (0, "clivalue"), p
    assert os.path.exists(os.path.join(net.root, "data", "p1", "ledgers"))
