"""Deliver failover over the port's wire (fabric_mod_tpu_torch/peer/
blocksprovider.py) against the reference's over grpcio
(fabric_mod_tpu/peer/blocksprovider.py): the reference's three scenarios
(tests/test_blocksprovider.py) and the fault seam, each run on both.

A reference e2e Network (solo, five transactions a block, a ten-second
batch timeout, so only counts cut blocks) and the port's Network on its
material (convert.network_material_from_reference: the same channel,
members and keys) get the same endorsed envelopes, in the same order,
at the same points of each scenario.  Each side serves its registrar
through its own OrdererServers, and its own DeliverClient pulls through
its own FailoverDeliverSource over their endpoints.  After each scenario
both peers must hold blocks of equal data with equal txflags, and equal
state fingerprints.
- The serving orderer dies mid-stream (stop with no grace): the source
  rotates to the second endpoint and the peer commits every tx, no gap.
- One orderer serves blocks with a corrupted orderer signature: the MCS
  rejects them, `report_bad_block` re-fetches from the good orderer and
  commit proceeds.
- Every endpoint down: the source backs off (nothing received; the
  port's has rotated) and resumes from the needed height when one comes
  up; both sources yield the same blocks.
- The seam `deliver.failover.stream` armed to kill a stream on its
  second message (block 2; the peer holds genesis): the source rotates
  away and the peer still commits every tx; the rule fired once.
"""
import threading
import time

import pytest
from fabric_mod_tpu import faults as jfaults
from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.orderer.server import OrdererServer as JServer
from fabric_mod_tpu.peer import blocksprovider as jbp
from fabric_mod_tpu.peer.deliverclient import DeliverClient as JDeliverClient
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert, e2e, faults
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.orderer.server import OrdererServer
from fabric_mod_tpu_torch.peer import blocksprovider as bp
from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
from fabric_mod_tpu_torch.peer.endorser import endorse_and_submit
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

BLOCK_TXS = 5


class Side:
    """One package's network and the transport classes to serve and pull
    it with."""

    def __init__(self, net, server, endpoint, source, client, msgs, putil,
                 fault_mod):
        self.net = net
        self.server = server
        self.endpoint = endpoint
        self.source = source
        self.client = client
        self.m = msgs
        self.protoutil = putil
        self.faults = fault_mod

    def submit(self, raws):
        for raw in raws:
            self.net.broadcast.submit(self.m.Envelope.decode(raw))

    def committed(self) -> int:
        led = self.net.ledger
        return sum(len(led.get_block_by_number(n).data.data)
                   for n in range(1, led.height))

    def outcome(self):
        """Each committed block's data and txflags, and the state."""
        led = self.net.ledger
        blocks = [(bytes(blk.data.encode()),
                   list(self.protoutil.block_txflags(blk)))
                  for blk in (led.get_block_by_number(n)
                              for n in range(1, led.height))]
        return blocks, led.state_fingerprint()


class _Recorder:
    """A broadcast that keeps the encoded envelopes it is given."""

    def __init__(self):
        self.raws = []

    def submit(self, env):
        self.raws.append(env.encode())


@pytest.fixture()
def world(tmp_path):
    ref = JNetwork(str(tmp_path / "ref"), max_message_count=BLOCK_TXS,
                   batch_timeout="10s")
    net = e2e.Network(str(tmp_path / "port"),
                      convert.network_material_from_reference(ref),
                      verifier=sw.SwVerifier())
    sides = {
        "ref": Side(ref, JServer, jbp.Endpoint, jbp.FailoverDeliverSource,
                    JDeliverClient, jm, jprotoutil, jfaults),
        "port": Side(net, OrdererServer, bp.Endpoint,
                     bp.FailoverDeliverSource, DeliverClient, m, protoutil,
                     faults)}
    yield sides
    net.close()
    ref.close()


def _envs(world, tag, n):
    """`n` puts of fresh keys, endorsed by the first two orgs' peers (the
    port's endorsers, on the reference's keys) and signed by the client,
    encoded."""
    net = world["port"].net
    rec = _Recorder()
    for i in range(n):
        endorse_and_submit(
            net.channel_id, fixtures.NAMESPACE,
            [b"put", tag + b"k%d" % i, tag + b"v%d" % i], net.client,
            [net.endorsers[o] for o in list(net.endorsers)[:2]], rec)
    return rec.raws


def _wait(pred, t=30.0):
    deadline = time.time() + t
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _tampering(side):
    """An OrdererServer of `side`'s package that serves real blocks with
    corrupted orderer signatures from block `tamper_from` on: an orderer
    whose blocks fail the MCS."""
    msgs = side.m

    class TamperingOrdererServer(side.server):
        def __init__(self, registrar, tamper_from: int = 1, **kw):
            super().__init__(registrar, **kw)
            self._tamper_from = tamper_from

        def _handle_deliver(self, request_iter, context):
            for raw in super()._handle_deliver(request_iter, context):
                resp = msgs.DeliverResponse.decode(raw)
                if (resp.block is not None
                        and resp.block.header.number >= self._tamper_from
                        and resp.block.metadata is not None
                        and resp.block.metadata.metadata):
                    md = list(resp.block.metadata.metadata)
                    md[0] = b"\x00" * max(1, len(md[0]))
                    resp.block.metadata.metadata = md
                    yield resp.encode()
                else:
                    yield raw
    return TamperingOrdererServer


def _pull(side, source):
    dc = side.client(side.net.channel, source)
    t = threading.Thread(target=lambda: dc.run(idle_timeout_s=5.0),
                         daemon=True)
    t.start()
    return dc, t


def _source(side, servers, **kw):
    return side.source([side.endpoint(f"127.0.0.1:{s.port}")
                        for s in servers], side.net.channel_id,
                       base_backoff_s=0.05, **kw)


def _rotation_after_mid_stream_server_death(side, first, second):
    srv_a = side.server(side.net.registrar, "127.0.0.1:0")
    srv_b = side.server(side.net.registrar, "127.0.0.1:0")
    srv_a.start()
    srv_b.start()
    try:
        source = _source(side, (srv_a, srv_b))
        dc, t = _pull(side, source)
        side.submit(first)
        assert _wait(lambda: side.net.ledger.height >= 3), "no commits"
        srv_a.stop(grace=0)                # mid-stream death (abort)
        side.submit(second)
        assert _wait(lambda: side.committed() >= 20), \
            f"height {side.net.ledger.height}, rotations {source.rotations}"
        assert source.rotations >= 1
        qe = side.net.ledger.new_query_executor()
        assert qe.get_state(fixtures.NAMESPACE, "fk15") == b"fv15"
        dc.stop()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        srv_b.stop()
    return side.outcome()


def test_rotation_after_mid_stream_server_death(world):
    envs = _envs(world, b"f", 4 * BLOCK_TXS)
    first, second = envs[:2 * BLOCK_TXS], envs[2 * BLOCK_TXS:]
    got = {name: _rotation_after_mid_stream_server_death(side, first,
                                                         second)
           for name, side in world.items()}
    assert got["port"] == got["ref"]
    assert [f for _, f in got["port"][0]] == \
        [[m.TxValidationCode.VALID] * BLOCK_TXS] * 4


def _bad_block_rotates_instead_of_halting(side, envs):
    evil = _tampering(side)(side.net.registrar, tamper_from=1,
                            address="127.0.0.1:0")
    good = side.server(side.net.registrar, "127.0.0.1:0")
    evil.start()
    good.start()
    try:
        source = _source(side, (evil, good))
        dc, t = _pull(side, source)
        side.submit(envs)
        assert _wait(lambda: side.committed() >= len(envs)), (
            f"height {side.net.ledger.height}, rejected {dc.rejected}, "
            f"rotations {source.rotations}")
        assert dc.rejected, "the evil orderer was never consulted"
        assert source.rotations >= 1
        dc.stop()
        t.join(timeout=10)
    finally:
        evil.stop()
        good.stop()
    return side.outcome()


def test_bad_block_rotates_instead_of_halting(world):
    envs = _envs(world, b"b", 2 * BLOCK_TXS)
    got = {name: _bad_block_rotates_instead_of_halting(side, envs)
           for name, side in world.items()}
    assert got["port"] == got["ref"]
    assert [f for _, f in got["port"][0]] == \
        [[m.TxValidationCode.VALID] * BLOCK_TXS] * 2


def _all_endpoints_down_backs_off_then_recovers(side, envs):
    srv = side.server(side.net.registrar, "127.0.0.1:0")
    # not started: the only endpoint is dead
    source = _source(side, (srv,), max_backoff_s=0.2)
    got = []
    stop = threading.Event()

    def pull():
        for blk in source.blocks(0, stop=None, stop_event=stop,
                                 timeout_s=2.0):
            got.append(blk)

    t = threading.Thread(target=pull, daemon=True)
    t.start()
    time.sleep(0.5)
    assert not got
    rotations = source.rotations
    srv.start()
    try:
        side.submit(envs)
        assert _wait(lambda: len(got) >= 2), got   # genesis + block 1
        stop.set()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        srv.stop()
    nums = [blk.header.number for blk in got]
    assert nums == sorted(nums)
    return [(blk.header.number, bytes(blk.data.encode()))
            for blk in got], rotations


def test_all_endpoints_down_backs_off_then_recovers(world):
    envs = _envs(world, b"r", BLOCK_TXS)
    got = {name: _all_endpoints_down_backs_off_then_recovers(side, envs)
           for name, side in world.items()}
    assert got["port"][0] == got["ref"][0]
    assert [n for n, _ in got["port"][0]] == [0, 1]
    # the port's dial fails at once, so its source has rotated (backing
    # off between rounds); grpcio's channel waits in its own connect
    # backoff, so the reference's count at that point is not compared
    assert got["port"][1] >= 2


def _failover_stream_seam_rotates_away(side, envs):
    srv_a = side.server(side.net.registrar, "127.0.0.1:0")
    srv_b = side.server(side.net.registrar, "127.0.0.1:0")
    srv_a.start()
    srv_b.start()
    plan = side.faults.FaultPlan().add("deliver.failover.stream", nth=2)
    try:
        side.submit(envs)
        source = _source(side, (srv_a, srv_b))
        with side.faults.active(plan):
            dc, t = _pull(side, source)
            assert _wait(lambda: side.committed() >= len(envs)), \
                f"height {side.net.ledger.height}"
        assert plan.fires("deliver.failover.stream") == 1
        assert source.rotations >= 1
        assert side.committed() == len(envs)
        dc.stop()
        t.join(timeout=10)
    finally:
        srv_a.stop()
        srv_b.stop()
    return side.outcome()


def test_failover_stream_seam_rotates_away(world):
    envs = _envs(world, b"s", 2 * BLOCK_TXS)
    got = {name: _failover_stream_seam_rotates_away(side, envs)
           for name, side in world.items()}
    assert got["port"] == got["ref"]
    assert [f for _, f in got["port"][0]] == \
        [[m.TxValidationCode.VALID] * BLOCK_TXS] * 2
