"""The port's gossip service, its deliver hook and its failure paths.

- Election-owned deliver over the port's solo e2e `Network` (host
  verifier): three gossip peers join by signed alive messages on a
  manual clock; the minimum-PKI-ID peer's deliver client commits and
  pushes, the others commit through their state providers.  The leader
  stops; the clock moves, the survivors' alive messages refresh each
  other, an expiry check (`now` from the clock) drops the dead leader,
  and one manual election tick promotes the next peer, whose client
  resumes from its own height.  The election loops run with an interval
  the test never reaches, so these ticks are the only ones.
- `DeliverClient(on_commit=...)` and `PipelinedCommitter(on_commit=...)`
  fire once a committed block, in order; what the hook raises fails the
  pipe: `run()` re-raises it, and the pipe's next submit raises it.
- No fallback: a verifier that raises makes the error come out of
  `InProcNetwork.send` and `GossipNode.on_message`, and a commit that
  raises is kept in the state provider's `errors` (synchronous commit
  and commit pipe), the block left requestable; a follower's verifier
  error reaches the leader's deliver client through its push and is
  kept by the service, which stops pulling.
"""
import threading
import time

import pytest

from tests._torch_gossip_world import PortPeer, seed_membership
from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.gossip import GossipService, InProcNetwork
from fabric_mod_tpu_torch.gossip.protoext import sign_message
from fabric_mod_tpu_torch.orderer import DeliverService
from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

BLOCK_TXS = 8
WAIT_S = 120.0
NEVER_S = 3600.0        # an election interval no test reaches


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.fixture()
def ordered(tmp_path):
    """A solo network on the host verifier and its material (3 gossip
    signers); yields (net, material, feed) where feed(n) orders n more
    put blocks of BLOCK_TXS."""
    material = fixtures.make_network_material(
        4, max_message_count=BLOCK_TXS, batch_timeout="60s", gossip_peers=3)
    net = e2e.Network(str(tmp_path / "net"), material=material,
                      verifier=sw.SwVerifier())
    sent = [0]

    def feed(n_blocks):
        for i in range(n_blocks * BLOCK_TXS):
            k = sent[0] + i
            sp, prop, _ = protoutil.create_chaincode_proposal(
                net.channel_id, "mycc", [b"put", b"sk%d" % k, b"v%d" % k],
                net.client)
            responses = [net.endorsers[o].process_proposal(sp)
                         for o in ("Org1", "Org2")]
            net.broadcast.submit(protoutil.create_tx_from_responses(
                prop, responses, net.client))
        sent[0] += n_blocks * BLOCK_TXS
    yield net, material, feed
    net.close()


def test_leader_commits_others_follow_and_hand_over(ordered, tmp_path):
    net, material, feed = ordered
    clock = ManualClock(1000.0)
    fabric = InProcNetwork()
    peers = [PortPeer(str(tmp_path), i, material.genesis, pems, fabric,
                      sw.SwVerifier(), clock=clock.monotonic)
             for i, pems in enumerate(material.gossip_peers)]
    services = [GossipService(p.node, lambda: DeliverService(net.support),
                              election_interval_s=NEVER_S) for p in peers]
    stopped = set()
    try:
        endpoints = [p.node.endpoint for p in peers]
        for p in peers:
            p.node.join(endpoints)
        for p in peers:
            p.node.discovery.tick_send_alive()
        for p in peers:
            assert len(p.node.discovery.alive_members()) == 2
        for s in services:
            s.start()
        lead = min(range(3), key=lambda i: peers[i].node.pki_id)
        assert [s.is_leader for s in services] == [i == lead
                                                   for i in range(3)]
        assert [s.client is not None for s in services] == \
            [i == lead for i in range(3)]

        feed(2)
        assert _wait(lambda: all(p.ledger.height == 3 for p in peers)), \
            [p.ledger.height for p in peers]

        # the leader dies; the survivors refresh each other later
        services[lead].stop()
        peers[lead].close()
        stopped.add(lead)
        survivors = [i for i in range(3) if i != lead]
        clock.advance(10.0)
        for i in survivors:
            peers[i].node.discovery.tick_send_alive()
        for i in survivors:
            expired = peers[i].node.discovery.tick_check_alive(
                now=clock.monotonic())
            assert expired == [peers[lead].node.pki_id]
        verdicts = [services[i].election.tick() for i in survivors]
        nxt = min(survivors, key=lambda i: peers[i].node.pki_id)
        assert verdicts == [i == nxt for i in survivors]
        client = services[nxt].client
        assert client is not None

        feed(1)
        assert _wait(lambda: all(peers[i].ledger.height == 4
                                 for i in survivors)), \
            [peers[i].ledger.height for i in survivors]
        fps = {peers[i].ledger.state_fingerprint() for i in survivors}
        assert len(fps) == 1
        for i in survivors:
            assert services[i].errors == []
            assert peers[i].node.state.errors == []
            qe = peers[i].ledger.state
            assert qe.get_state("mycc", "sk17")[0] == b"v17"
    finally:
        for i, s in enumerate(services):
            if i not in stopped:
                s.stop()
                peers[i].close()


def _ordered_blocks(net, feed, n):
    """The next `n` blocks the orderer cuts."""
    first = net.support.store.height
    feed(n)
    assert _wait(lambda: net.support.store.height == first + n)
    return [net.support.store.get_block_by_number(b)
            for b in range(first, first + n)]


def test_deliver_client_on_commit_in_order_and_raises(ordered):
    net, _, feed = ordered
    _ordered_blocks(net, feed, 3)
    seen = []
    client = DeliverClient(net.channel, net.deliver,
                           on_commit=lambda b: seen.append(b.header.number))
    done = threading.Event()

    def stop_at_height():
        _wait(lambda: net.ledger.height == 4)
        client.stop()
        done.set()
    threading.Thread(target=stop_at_height, daemon=True).start()
    client.run(idle_timeout_s=WAIT_S)
    assert done.wait(WAIT_S)
    assert seen == [1, 2, 3]

    # a hook that raises: the pipe fails and run() re-raises it
    feed(1)

    def boom(block):
        raise RuntimeError(f"verifier fault at block {block.header.number}")
    with pytest.raises(RuntimeError, match="block 4"):
        DeliverClient(net.channel, net.deliver, on_commit=boom).run(
            idle_timeout_s=WAIT_S)
    assert net.ledger.height == 5         # committed, then the hook raised


def test_pipelined_committer_on_commit(ordered, tmp_path):
    net, material, feed = ordered
    blocks = _ordered_blocks(net, feed, 2)
    peer = PortPeer(str(tmp_path), 0, material.genesis,
                    material.gossip_peers[0], InProcNetwork(),
                    sw.SwVerifier())
    try:
        seen = []
        pipe = PipelinedCommitter(
            peer.channel, on_commit=lambda b, f: seen.append(
                (b.header.number, list(f))))
        for b in blocks:
            pipe.submit(b)
        assert pipe.flush(WAIT_S)
        pipe.close()
        assert [n for n, _ in seen] == [1, 2]
        assert [f for _, f in seen] == [
            list(protoutil.block_txflags(peer.ledger.get_block_by_number(n)))
            for n in (1, 2)]
        more = _ordered_blocks(net, feed, 1)[0]

        def boom(block, flags):
            raise RuntimeError("hook fault")
        pipe = PipelinedCommitter(peer.channel, on_commit=boom)
        pipe.submit(more)
        pipe.close()                      # joins: the hook has run
        assert peer.ledger.height == 4    # committed, then the hook raised
        assert isinstance(pipe.error, RuntimeError)
        with pytest.raises(RuntimeError, match="hook fault"):
            pipe.submit(more)
    finally:
        peer.close()


class _FaultyVerifier(sw.SwVerifier):
    """Verifies on the host, but raises as a broken device would: on
    every call (`all_calls`), or on calls of more than one item (a
    block commit's batch, not an envelope or MCS check)."""

    def __init__(self, all_calls):
        self.all_calls = all_calls

    def verify_many(self, items):
        if self.all_calls or len(items) > 1:
            raise RuntimeError("device fault")
        return super().verify_many(items)


@pytest.mark.parametrize("depth", [0, 2])
def test_verifier_errors_are_not_swallowed(ordered, tmp_path, depth):
    net, material, feed = ordered
    block = _ordered_blocks(net, feed, 1)[0]
    fabric = InProcNetwork()
    verifier = _FaultyVerifier(all_calls=True)
    peers = [PortPeer(str(tmp_path), i, material.genesis, pems, fabric,
                      verifier, pipeline_depth=depth)
             for i, pems in enumerate(material.gossip_peers[:2])]
    try:
        sender, receiver = (p.node for p in peers)
        seed_membership([sender, receiver], m)
        msg = m.GossipMessage(nonce=7, data_msg=m.DataMessage(
            payload=m.GossipPayload(seq_num=1, data=block.encode())))
        raw = sign_message(msg, sender._signer).encode()
        # the envelope check raises: out of on_message, out of send,
        # out of a push
        with pytest.raises(RuntimeError, match="device fault"):
            receiver.on_message(sender.pki_id, raw)
        with pytest.raises(RuntimeError, match="device fault"):
            fabric.send(sender.endpoint, sender.pki_id, receiver.endpoint,
                        raw)
        with pytest.raises(RuntimeError, match="device fault"):
            sender.gossip_block(block)
        assert receiver.state.buffer.next_seq == 1

        # envelope and MCS pass, the commit's batch raises: kept by the
        # provider, the block left requestable
        verifier.all_calls = False
        receiver.state.start(interval_s=NEVER_S)
        sender.gossip_block(block)
        if depth:
            # the pipe fails on its own thread: its flush raises, and the
            # provider keeps the failure when it next looks at the pipe
            assert _wait(lambda: receiver.state.buffer.next_seq == 2)
            with pytest.raises(RuntimeError, match="device fault"):
                receiver.state.flush(WAIT_S)
            receiver.state.anti_entropy_tick()
        assert _wait(lambda: receiver.state.errors, WAIT_S)
        assert all(isinstance(e, RuntimeError) for e in
                   receiver.state.errors)
        assert peers[1].ledger.height == 1
        assert receiver.state.buffer.next_seq == 1
    finally:
        for p in peers:
            p.close()


def test_leader_keeps_a_push_error(ordered, tmp_path):
    """A follower whose verifier raises: the leader's push carries the
    error back into its deliver client's commit hook, the client ends,
    and the service keeps the error instead of pulling again."""
    net, material, feed = ordered
    fabric = InProcNetwork()
    leader, follower = (
        PortPeer(str(tmp_path), i, material.genesis, pems, fabric, verifier)
        for i, (pems, verifier) in enumerate(zip(
            material.gossip_peers, (sw.SwVerifier(),
                                    _FaultyVerifier(all_calls=True)))))
    service = GossipService(leader.node, lambda: DeliverService(net.support),
                            static_leader=True, election_interval_s=NEVER_S)
    try:
        seed_membership([leader.node, follower.node], m)
        service.start()
        feed(1)
        assert _wait(lambda: service.errors)
        assert [type(e) for e in service.errors] == [RuntimeError]
        assert "device fault" in str(service.errors[0])
        assert leader.ledger.height == 2 and follower.ledger.height == 1
    finally:
        service.stop()
        leader.close()
        follower.close()
