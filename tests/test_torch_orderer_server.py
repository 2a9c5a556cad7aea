"""The port's orderer server (fabric_mod_tpu_torch/orderer/server.py) over
its wire, against the reference's OrdererServer over grpcio.

One reference e2e Network (solo, five transactions a block, a ten-second
batch timeout so only counts cut blocks) and the port's Network on its
material (convert.network_material_from_reference: the same channel,
members and keys) each get an OrdererServer.  The same envelope bytes
go to both Broadcast streams: ten valid transactions, a tampered one
and junk.  The answers must be equal; the Deliver streams of both must
then give blocks with equal headers and data (the orderers' signatures
differ, so metadata is not compared) and equal statuses, for a bounded
seek, a seek of a channel neither serves and a garbage seek.  An
admission rate limit on a manual clock sheds with RESOURCE_EXHAUSTED and
the same retry-after at both; a leaderless chain answers
SERVICE_UNAVAILABLE with the same leader hint, which the port's
GrpcBroadcaster follows to another server before any backoff.
"""
import pytest
from fabric_mod_tpu.comm.grpc_comm import GRPCClient as JClient
from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.ledger.rwsetutil import RWSetBuilder as JRWSet
from fabric_mod_tpu.orderer import admission as jadmission
from fabric_mod_tpu.orderer.broadcast import Broadcast as JBroadcast
from fabric_mod_tpu.orderer.consensus import NotLeaderError as JNotLeader
from fabric_mod_tpu.orderer.server import OrdererServer as JServer
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert, e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
from fabric_mod_tpu_torch.orderer import admission
from fabric_mod_tpu_torch.orderer.broadcast import Broadcast
from fabric_mod_tpu_torch.orderer.consensus import NotLeaderError
from fabric_mod_tpu_torch.orderer.server import (SERVICE, OrdererServer,
                                                 make_seek_envelope)
from fabric_mod_tpu_torch.peer.grpcdeliver import (
    BroadcastResourceExhausted, BroadcastUnavailable, GrpcBroadcaster,
    _parse_leader_hint, _parse_retry_after)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock
from fabric_mod_tpu_torch.utils.retry import Retrier

BLOCK_TXS = 5


@pytest.fixture()
def world(tmp_path):
    ref = JNetwork(str(tmp_path / "ref"), max_message_count=BLOCK_TXS,
                   batch_timeout="10s")
    net = e2e.Network(str(tmp_path / "port"),
                      convert.network_material_from_reference(ref),
                      verifier=sw.SwVerifier())
    jsrv = JServer(ref.registrar, "127.0.0.1:0")
    srv = OrdererServer(net.registrar, "127.0.0.1:0")
    jsrv.start()
    srv.start()
    jcli = JClient(f"127.0.0.1:{jsrv.port}")
    cli = GRPCClient(f"127.0.0.1:{srv.port}")
    yield {"ref": ref, "net": net, "jsrv": jsrv, "srv": srv, "jcli": jcli,
           "cli": cli}
    cli.close()
    jcli.close()
    srv.stop()
    jsrv.stop()
    net.close()
    ref.close()


def _envs(ref, n):
    out = []
    for i in range(n):
        b = JRWSet()
        b.add_write("mycc", f"k{i}", b"v%d" % i)
        out.append(jprotoutil.create_signed_tx(
            ref.channel_id, "mycc", b.build().encode(), ref.client,
            [ref.client]).encode())
    return out


def _answers(client, raws):
    stream = client.stream_stream(SERVICE, "Broadcast", iter(raws),
                                  timeout=30)
    return [(r.status, r.info) for r in
            (m.BroadcastResponse.decode(x) for x in stream)]


def _deliver(client, raw_seek):
    return [m.DeliverResponse.decode(x) for x in client.stream_stream(
        SERVICE, "Deliver", iter([raw_seek]), timeout=30)]


def test_broadcast_and_deliver_answer_like_the_reference(world):
    ref = world["ref"]
    raws = _envs(ref, 2 * BLOCK_TXS)
    tampered = bytearray(raws[0])
    tampered[-3] ^= 0x01                  # inside the signature
    sent = raws[:3] + [bytes(tampered), b"\xff\x01junk"] + raws[3:]
    want = _answers(world["jcli"], sent)
    got = _answers(world["cli"], sent)
    assert got == want
    assert [s for s, _ in got].count(m.Status.SUCCESS) == 2 * BLOCK_TXS
    # the tampered creator signature is refused; junk fails to decode
    assert [s for s, _ in got][3:5] == [m.Status.BAD_REQUEST,
                                       m.Status.INTERNAL_SERVER_ERROR]

    seek = make_seek_envelope(ref.channel_id, 0, 2).encode()
    got, want = _deliver(world["cli"], seek), _deliver(world["jcli"], seek)
    assert [r.status for r in got] == [r.status for r in want] == \
        [m.Status.UNKNOWN] * 3 + [m.Status.SUCCESS]
    for mine, theirs in zip(got[:-1], want[:-1]):
        assert mine.block.header.encode() == theirs.block.header.encode()
        assert mine.block.data.encode() == theirs.block.data.encode()
    for raw in (make_seek_envelope("nochannel", 0, 0).encode(),
                b"\x00garbage"):
        assert [r.encode() for r in _deliver(world["cli"], raw)] == \
            [r.encode() for r in _deliver(world["jcli"], raw)]


def test_admission_shed_is_resource_exhausted_at_both(world):
    ref, net = world["ref"], world["net"]
    clock, jclock = ManualClock(), ManualClock()
    world["srv"]._broadcast = Broadcast(
        net.registrar, admission=admission.AdmissionController(
            limiter=admission.ClientRateLimiter(2.0, 1.0, clock=clock),
            clock=clock))
    world["jsrv"]._broadcast = JBroadcast(
        ref.registrar, admission=jadmission.AdmissionController(
            limiter=jadmission.ClientRateLimiter(2.0, 1.0, clock=jclock),
            clock=jclock))
    raws = _envs(ref, 3)
    got, want = _answers(world["cli"], raws), _answers(world["jcli"], raws)
    assert got == want
    assert [s for s, _ in got] == [m.Status.SUCCESS] + \
        [m.Status.RESOURCE_EXHAUSTED] * 2
    assert _parse_retry_after(got[1][1]) == 0.5
    # the port's client types the shed and carries the hint
    bcast = GrpcBroadcaster(world["cli"])
    with pytest.raises(BroadcastResourceExhausted) as shed:
        bcast.submit(m.Envelope.decode(raws[0]))
    assert shed.value.retry_after_s == 0.5
    bcast.close()
    # with a Retrier: each retry first sleeps the server's hint (the
    # manual clock never refills the bucket, so every attempt is shed)
    sleeps = []
    bcast = GrpcBroadcaster(world["cli"], retrier=Retrier(
        base_s=0.0, jitter=0.0, max_attempts=3, sleep=lambda s: None),
        sleep=sleeps.append)
    with pytest.raises(BroadcastResourceExhausted):
        bcast.submit(m.Envelope.decode(raws[1]))
    assert sleeps == [0.5, 0.5]
    bcast.close()


class _Leaderless:
    """A Broadcast stand-in whose chain lost its leader."""

    def __init__(self, err):
        self._err = err

    def submit(self, env):
        raise self._err


def test_leader_hint_is_answered_alike_and_followed(world):
    world["srv"]._broadcast = _Leaderless(NotLeaderError("x", "o2"))
    world["jsrv"]._broadcast = _Leaderless(JNotLeader("x", "o2"))
    raws = _envs(world["ref"], 1)
    got, want = _answers(world["cli"], raws), _answers(world["jcli"], raws)
    assert got == want == [(m.Status.SERVICE_UNAVAILABLE,
                            "no leader: retry; try o2")]
    assert _parse_leader_hint(got[0][1]) == "o2"
    # without redial: typed, with the hint
    bcast = GrpcBroadcaster(world["cli"])
    with pytest.raises(BroadcastUnavailable) as unav:
        bcast.submit(m.Envelope.decode(raws[0]))
    assert unav.value.leader_hint == "o2"
    bcast.close()
    # with redial: the hinted "leader" is a healthy server, taken at once
    good = OrdererServer(world["net"].registrar, "127.0.0.1:0")
    good.start()
    dialed = []

    def redial(lead):
        dialed.append(lead)
        return GRPCClient(f"127.0.0.1:{good.port}")
    sleeps = []
    bcast = GrpcBroadcaster(world["cli"], redial=redial,
                            sleep=sleeps.append)
    try:
        bcast.submit(m.Envelope.decode(raws[0]))
        assert dialed == ["o2"] and sleeps == []
    finally:
        bcast.close()
        good.stop()
