"""The port's dissemination trees (dissemination/), against the reference
and in a relay world on the host verifier.

- `RelayTree` and `reparent_plan` equal to the reference's, member for
  member, over seeded member sets, epochs, degrees 1-6, dead interior
  members and a dead leader; a relay envelope signed by either package
  decodes in the other and re-encodes to the same bytes.
- The reference's cases of tests/test_dissemination.py on the port:
  the tree's determinism, epoch rotation and reparenting, the bounded
  per-child queues (overflow sheds the oldest frame, counted), a push to
  nobody, the demote/promote transitions and the epoch's advance on
  membership change.
- An 8-peer relay world (degree 2, interior forwarding) around the
  port's solo e2e `Network` on `sw.SwVerifier`: one orderer stream,
  every non-leader gets the whole chain through the tree, each frame
  byte-identical to a direct pull's (the network's own peer's ledger),
  one state fingerprint; gap repair when a wrapped `send_signed` drops
  chosen sends (the port has no fault points); a leadership flap on a
  manual clock demotes the dead root and the next leader relays from
  its height.
- No fallback: a verifier that raises on a child ends in the parent's
  `BlockRelay.errors` (the sender loop stops), not in a dropped frame;
  `on_relay` drops only undecodable frames and MCS rejections.
"""
import random
import threading
import time
import types

import pytest
from cryptography import x509 as jx509
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.dissemination import tree as jtree
from fabric_mod_tpu.gossip import comm as jcomm
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.protos import messages as jm

from tests._torch_relay_world import RelayWorld
from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.dissemination import (BlockRelay, RelayService,
                                                RelayTree, reparent_plan)
from fabric_mod_tpu_torch.gossip import comm
from fabric_mod_tpu_torch.gossip.protoext import verify_envelope
from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                 deserialize_cert)
from fabric_mod_tpu_torch.orderer import DeliverService
from fabric_mod_tpu_torch.peer.fanout import encode_frame
from fabric_mod_tpu_torch.peer.mcs import BlockVerificationError
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

SEED = 12
BLOCK_TXS = 2
N_PEERS = 8
WAIT_S = 120.0


def _wait(pred, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# ---------------------------------------------------------------------------
# RelayTree: the pure function, against the reference
# ---------------------------------------------------------------------------

def _tree_facts(t, probes):
    return (tuple(t.order), t.leader, t.epoch, t.degree, len(t),
            [(p, p in t, t.children(p), t.parent(p), t.depth(p))
             for p in probes])


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 6])
def test_tree_and_reparent_plan_equal_reference(degree):
    rng = random.Random(SEED * 10 + degree)
    for _ in range(12):
        n = rng.randrange(1, 40)
        members = [f"p{rng.randrange(1000)}:7051" for _ in range(n)]
        leader = rng.choice(members)
        epoch = rng.randrange(0, 9)
        probes = list(dict.fromkeys(members)) + ["stranger:7051"]
        t = RelayTree(members, leader, epoch=epoch, degree=degree)
        jt = jtree.RelayTree(members, leader, epoch=epoch, degree=degree)
        assert _tree_facts(t, probes) == _tree_facts(jt, probes)
        # an interior member dies, then the leader
        for dead in ([rng.choice(members)] if n > 1 else []) + [leader]:
            t2, jt2 = t.without(dead), jt.without(dead)
            assert _tree_facts(t2, probes) == _tree_facts(jt2, probes)
            assert reparent_plan(t, t2) == jtree.reparent_plan(jt, jt2)
        # a re-dealt epoch over the same members
        t3 = RelayTree(members, leader, epoch=epoch + 1, degree=degree)
        jt3 = jtree.RelayTree(members, leader, epoch=epoch + 1,
                              degree=degree)
        assert reparent_plan(t, t3) == jtree.reparent_plan(jt, jt3)


def test_tree_deterministic_regardless_of_member_order():
    members = [f"p{i}:7051" for i in range(13)]
    trees = []
    for seed in range(5):
        shuffled = list(members)
        random.Random(seed).shuffle(shuffled)
        trees.append(RelayTree(shuffled, leader="p7:7051", epoch=3,
                               degree=3))
    for t in trees[1:]:
        assert t.order == trees[0].order
    t = trees[0]
    assert t.order[0] == "p7:7051" and len(t) == 13
    seen = set()
    for mm in t.order:
        for c in t.children(mm):
            assert t.parent(c) == mm
            assert c not in seen
            seen.add(c)
    assert seen == set(members) - {"p7:7051"}
    for mm in t.order[1:]:
        assert t.depth(mm) == t.depth(t.parent(mm)) + 1
    assert t.depth("p7:7051") == 0
    assert t.depth("not-a-member") == -1
    assert t.children("not-a-member") == []


def test_tree_epoch_rotation_and_reparent_plan():
    members = [f"p{i}" for i in range(9)]
    t0 = RelayTree(members, leader="p0", epoch=0, degree=2)
    t1 = RelayTree(members, leader="p0", epoch=1, degree=2)
    assert t0.order[0] == t1.order[0] == "p0"
    assert t0.order != t1.order and set(t0.order) == set(t1.order)
    dead = t0.children("p0")[0]          # an interior member dies
    t2 = t0.without(dead)
    assert dead not in t2
    plan = reparent_plan(t0, t2)
    assert plan
    for member, (was, now) in plan.items():
        assert was != now
        assert (t0.parent(member), t2.parent(member)) == (was, now)
    for member in t2.order:
        if member not in plan:
            assert t0.parent(member) == t2.parent(member)
    # a dead leader: the survivors' minimum roots the tree
    t3 = RelayTree([f"p{i}" for i in range(5)], leader="p3").without("p3")
    assert t3.leader == "p0" == t3.order[0] and len(t3) == 4


def test_relay_envelope_crosses_packages_as_bytes():
    """A relay envelope signed once by either package decodes in the
    other, re-encodes to the same bytes and verifies."""
    mat = fixtures.make_network_material(SEED, gossip_peers=1)
    mspid, cert, key = mat.gossip_peers[0]
    signer = SigningIdentity(mspid, deserialize_cert(cert), key, sw.SwCSP())
    jsigner = JSigner(mspid, jx509.load_pem_x509_certificate(cert), key,
                      JSwCSP())
    frame = encode_frame("ch", "full", fixtures.make_fanout_chain("ch")[1])
    msg = m.GossipMessage(channel=b"ch", relay_msg=m.RelayMessage(
        seq_num=1, frame=frame, config=0))
    jmsg = jm.GossipMessage.decode(msg.encode())
    assert jmsg.encode() == msg.encode()
    env = comm.GossipComm("a:1", b"p", comm.InProcNetwork(),
                          signer).sign_once(msg)
    jenv = jcomm.GossipComm("a:1", b"p", jcomm.InProcNetwork(),
                            jsigner).sign_once(jmsg)
    for raw in (env, jenv):
        assert jm.GossipEnvelope.decode(raw).encode() == raw
        penv = m.GossipEnvelope.decode(raw)
        assert penv.encode() == raw
        got = verify_envelope(penv, signer.verify)
        assert got is not None and got.relay_msg.frame == frame


# ---------------------------------------------------------------------------
# BlockRelay and RelayService units
# ---------------------------------------------------------------------------

def _fake_node(endpoint="root:7051", cid="ch", height=0, members=()):
    return types.SimpleNamespace(
        endpoint=endpoint, pki_id=endpoint.encode(),
        _channel=types.SimpleNamespace(
            channel_id=cid, ledger=types.SimpleNamespace(
                height=height, get_block_by_number=lambda n: None)),
        discovery=types.SimpleNamespace(alive_members=lambda: list(members)),
        comm=None, state=None, on_relay=None)


def test_child_queue_overflow_sheds_oldest_counted():
    tree = RelayTree(["root:7051", "a:7051", "b:7051"],
                     leader="root:7051", degree=2)
    relay = BlockRelay(_fake_node(), lambda: tree, queue_cap=2)
    for num in range(5):                 # never started: frames pile up
        assert relay.push_frame(num, b"frame%d" % num) == 2
    assert relay.stats["dropped"] == 6   # 3 shed x 2 children
    with relay._lock:
        for child in ("a:7051", "b:7051"):
            assert [num for num, _, _ in relay._queues[child]] == [3, 4]
    assert relay.clear() == 4
    assert relay.push_frame(9, b"f") == 2
    assert relay._cap == 2 and BlockRelay(
        _fake_node(), lambda: tree)._cap == 64     # the reference default


def test_push_to_nobody_is_free():
    tree = RelayTree(["leaf:7051", "root:7051"], leader="root:7051")
    relay = BlockRelay(_fake_node("leaf:7051"), lambda: tree, queue_cap=4)
    assert relay.push_frame(1, b"x") == 0
    assert relay.stats["dropped"] == 0 and not relay._queues


def test_demoted_root_stops_pushing_promotion_resumes():
    a = types.SimpleNamespace(endpoint="a:7051", pki_id=b"\xff")
    node = _fake_node("r:7051", height=7, members=[a])
    svc = RelayService(node)
    assert (svc._degree, svc.relay._cap, svc._ring._ring_size) == \
        (4, 64, 128)                     # the reference's defaults
    svc.relay.push_frame(1, b"x")
    svc.on_leadership(True)
    assert svc._is_root and svc._root_from == 7
    with svc.relay._lock:                # the promotion cleared the queue
        assert not any(svc.relay._queues.values())
    svc.relay.push_frame(8, b"y")
    svc.on_leadership(False)
    assert not svc._is_root
    with svc.relay._lock:
        assert not any(svc.relay._queues.values())
    # demoted mid-callback: the leader hook pushes nothing
    block = m.Block(header=m.BlockHeader(number=8))
    svc.on_leader_commit(block)
    assert not svc.relay._queues


def test_relay_epoch_advances_on_membership_change_and_reparents():
    eps = [f"p{i}:7051" for i in range(1, 9)]
    alive = [types.SimpleNamespace(endpoint=e, pki_id=e.encode())
             for e in eps]
    node = _fake_node("p0:7051")
    node.discovery.alive_members = lambda: list(alive)
    svc = RelayService(node, degree=2, leader_source=lambda: "p0:7051")
    svc._note_membership(["r:7051", "a:7051", "b:7051"])
    assert svc.epoch == 0                  # the first view only seeds
    svc._note_membership(["a:7051", "r:7051", "b:7051"])
    assert svc.epoch == 0                  # a reordering is not churn
    svc._note_membership(["r:7051", "a:7051"])       # a crash expiry
    assert svc.epoch == 1
    t0 = svc.tree()                        # the real view: a change
    assert svc.epoch == 2
    dead = alive.pop()                     # a member expires
    during = svc.tree()
    assert svc.epoch == 3 and dead.endpoint not in during
    alive.append(dead)                     # ...and rejoins
    t1 = svc.tree()
    assert svc.epoch == 4 and set(t1.order) == set(t0.order)
    plan = reparent_plan(t0, t1)
    assert plan
    for member, (was, now) in plan.items():
        assert (t0.parent(member), t1.parent(member)) == (was, now)
    assert svc.bump_epoch() == 5


def _relay_unit(verify_block):
    """A BlockRelay on a fake node whose MCS is `verify_block`."""
    added = []
    node = _fake_node("c:7051")
    node._channel.mcs = types.SimpleNamespace(verify_block=verify_block)
    node.state = types.SimpleNamespace(
        add_block=added.append,
        buffer=types.SimpleNamespace(missing_range=lambda: None))
    tree = RelayTree(["r:7051", "c:7051"], leader="r:7051")
    return BlockRelay(node, lambda: tree), added


def _relay_msg(frame, cid=b"ch"):
    return m.GossipMessage(channel=cid, relay_msg=m.RelayMessage(
        seq_num=1, frame=frame))


def test_on_relay_drops_only_protocol_rejections():
    frame = encode_frame("ch", "full", fixtures.make_fanout_chain("ch")[1])

    def reject(cid, block):
        raise BlockVerificationError("bad orderer signature")
    relay, added = _relay_unit(reject)
    relay.on_relay(_relay_msg(frame))            # MCS rejection: dropped
    relay.on_relay(_relay_msg(b"\xff\xff\xff"))  # undecodable: dropped
    relay.on_relay(_relay_msg(frame, cid=b"other"))   # another channel
    assert added == [] and relay.stats["received"] == 2

    def device_fault(cid, block):
        raise RuntimeError("CUDA error: an illegal memory access")
    relay, added = _relay_unit(device_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        relay.on_relay(_relay_msg(frame))
    assert added == []

    relay, added = _relay_unit(lambda cid, block: None)
    relay.on_relay(_relay_msg(frame))
    assert [b.header.number for b in added] == [1]
    assert relay.stats["forwarded"] == 1


# ---------------------------------------------------------------------------
# The relay world: 8 relay-mode peers around the port's solo network
# ---------------------------------------------------------------------------

@pytest.fixture()
def ordered(tmp_path):
    """A solo network on the host verifier cutting BLOCK_TXS-tx blocks
    on count, and its material (N_PEERS gossip signers); yields (net,
    material, feed), feed(n) ordering n more put blocks."""
    material = fixtures.make_network_material(
        SEED, max_message_count=BLOCK_TXS, batch_timeout="60s",
        gossip_peers=N_PEERS)
    net = e2e.Network(str(tmp_path / "net"), material=material,
                      verifier=sw.SwVerifier())
    sent = [0]

    def feed(n_blocks):
        for i in range(n_blocks * BLOCK_TXS):
            k = sent[0] + i
            sp, prop, _ = protoutil.create_chaincode_proposal(
                net.channel_id, "mycc", [b"put", b"rk%d" % k, b"v%d" % k],
                net.client)
            responses = [net.endorsers[o].process_proposal(sp)
                         for o in ("Org1", "Org2")]
            net.broadcast.submit(protoutil.create_tx_from_responses(
                prop, responses, net.client))
        sent[0] += n_blocks * BLOCK_TXS
        target = 1 + sent[0] // BLOCK_TXS
        assert _wait(lambda: net.support.store.height == target)
        return target
    yield net, material, feed
    net.close()


def _direct_pull(net, height):
    """The network's own peer pulls from the orderer up to `height`:
    the frames a direct pull produces."""
    client = net.deliver_client()
    t = threading.Thread(target=client.run, kwargs={"idle_timeout_s": 30.0},
                         daemon=True)
    t.start()
    assert _wait(lambda: net.ledger.height >= height)
    client.stop()
    t.join(timeout=30)
    return {num: encode_frame(net.channel_id, "full",
                              net.ledger.get_block_by_number(num))
            for num in range(1, height)}


def _world(tmp_path, net, material, **kw):
    return RelayWorld(str(tmp_path), material,
                      lambda: DeliverService(net.support),
                      [sw.SwVerifier() for _ in material.gossip_peers],
                      **kw)


def test_relay_frames_byte_identical_to_direct_pull(ordered, tmp_path):
    net, material, feed = ordered
    world = _world(tmp_path, net, material, degree=2)
    try:
        world.start()
        target = feed(3)
        assert _wait(lambda: min(world.heights()) >= target), world.heights()
        assert world.errors() == []
        # one orderer stream served all eight peers
        assert len(world.streams) == 1
        assert [s.client is not None for s in world.services] == \
            [i == world.lead for i in range(N_PEERS)]
        refs = _direct_pull(net, target)
        tree = world.relays[world.lead].tree()
        assert max(tree.depth(p.node.endpoint) for p in world.peers) == 3
        for i, tap in enumerate(world.taps):
            if i == world.lead:
                assert not tap               # the root receives nothing
                continue
            got = dict(tap)
            assert set(got) == set(range(1, target)), (i, sorted(got))
            for num, frame in got.items():
                assert frame == refs[num], (i, num)
        fps = {p.ledger.state_fingerprint() for p in world.peers}
        assert fps == {net.ledger.state_fingerprint()}
        stats = [r.stats for r in world.relays]
        assert stats[world.lead]["pushed"] == 2 * (target - 1)
        assert sum(s["forwarded"] for s in stats) == \
            (N_PEERS - 1) * (target - 1)
        assert sum(s["dropped"] + s["send_failures"] for s in stats) == 0
        assert world.relays[world.lead].ring_stats["fallbacks"] == 0
    finally:
        world.close()


def test_gap_repair_when_chosen_sends_drop(ordered, tmp_path):
    net, material, feed = ordered
    world = _world(tmp_path, net, material, degree=2)
    try:
        lead = world.peers[world.lead].node
        victims = world.relays[world.lead].tree().children(lead.endpoint)
        inner = lead.comm.send_signed
        dropped = []

        def lossy(dst, env_bytes):
            num = m.GossipMessage.decode(
                m.GossipEnvelope.decode(env_bytes).payload).relay_msg.seq_num
            if (dst, num) in ((victims[0], 2), (victims[1], 3)):
                dropped.append((dst, num))
                return False
            return inner(dst, env_bytes)
        lead.comm.send_signed = lossy
        world.start()
        target = feed(4)
        assert _wait(lambda: min(world.heights()) >= target), world.heights()
        assert world.errors() == []
        assert sorted(dropped) == sorted([(victims[0], 2), (victims[1], 3)])
        assert world.relays[world.lead].stats["send_failures"] == 2
        assert sum(r.stats["repair_prods"] for r in world.relays) >= 1
        assert len({p.ledger.state_fingerprint() for p in world.peers}) == 1
    finally:
        world.close()


def test_leadership_flap_demotes_and_resumes_from_height(ordered, tmp_path):
    net, material, feed = ordered
    clock = ManualClock(1000.0)
    world = _world(tmp_path, net, material, degree=2, static=False,
                   clock=clock.monotonic)
    try:
        world.start()
        old = world.lead
        assert [s.is_leader for s in world.services] == \
            [i == old for i in range(N_PEERS)]
        target = feed(2)
        assert _wait(lambda: min(world.heights()) >= target)

        world.stop_peer(old)                   # the root dies
        assert world.relays[old].relay._thread is None
        survivors = [i for i in range(N_PEERS) if i != old]
        clock.advance(10.0)
        for i in survivors:
            world.peers[i].node.discovery.tick_send_alive()
        for i in survivors:
            assert world.peers[i].node.discovery.tick_check_alive(
                now=clock.monotonic()) == [world.peers[old].node.pki_id]
        verdicts = [world.services[i].election.tick() for i in survivors]
        nxt = min(survivors, key=lambda i: world.peers[i].node.pki_id)
        assert verdicts == [i == nxt for i in survivors]
        relay = world.relays[nxt]
        assert relay._is_root and relay._root_from == target
        pushed = relay.stats["pushed"]
        # every survivor saw one membership change: one epoch, one tree
        assert {world.relays[i].tree().order for i in survivors} == \
            {relay.tree().order}
        assert {world.relays[i].epoch for i in survivors} == {1}

        target = feed(2)
        assert _wait(lambda: min(world.heights()) >= target), world.heights()
        assert relay.stats["pushed"] > pushed
        assert world.errors() == []
        assert len(world.streams) == 2
        assert len({world.peers[i].ledger.state_fingerprint()
                    for i in survivors}) == 1
    finally:
        world.close()


class _Faulting:
    """A verifier that raises once armed (a device fault)."""

    def __init__(self):
        self._inner = sw.SwVerifier()
        self.armed = False

    def verify_many(self, items):
        if self.armed:
            raise RuntimeError("CUDA error: device-side assert triggered")
        return self._inner.verify_many(items)


def test_child_verifier_error_ends_in_parent_relay_errors(ordered,
                                                         tmp_path):
    net, material, feed = ordered
    verifiers = [sw.SwVerifier() for _ in material.gossip_peers]
    probe = RelayWorld(str(tmp_path / "probe"), material, lambda: None,
                       verifiers)
    lead, tree = probe.lead, probe.relays[probe.lead].tree()
    probe.close()
    child_ep = tree.children(f"gossip{lead}:7051")[0]
    bad = int(child_ep[len("gossip"):].split(":")[0])
    faulty = _Faulting()
    verifiers[bad] = faulty
    world = RelayWorld(str(tmp_path), material,
                       lambda: DeliverService(net.support), verifiers)
    try:
        world.start()
        faulty.armed = True
        target = feed(1)
        root = world.relays[world.lead].relay
        assert _wait(lambda: root.errors != [])
        assert "device-side assert" in str(root.errors[0])
        assert _wait(lambda: not root._thread.is_alive())
        assert world.taps[bad] == []             # no frame taken silently
        assert world.peers[bad].ledger.height == 1
        assert world.peers[world.lead].ledger.height == target
    finally:
        faulty.armed = False
        world.close()
