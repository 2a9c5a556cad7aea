"""The gossip layer's pieces, port against reference, on the same inputs.

Identities and channel config come from the port's seeded network
material (`fixtures.make_network_material(gossip_peers=3)`); each
package builds its own Bundle from the same genesis bytes and its own
signers from the same PEMs.  Checked: the PKI-ID of every identity;
`verify_envelope`'s verdicts and decoded messages on envelopes signed by
either package and crossed as bytes (intact, payload or signature
tampered, signer unknown, signature missing); the PayloadsBuffer and the
TTL message store on one seeded sequence of operations; the membership
view (freshness and expiry) and the election's verdicts and transitions
on one seeded sequence of membership changes.  All on the host.
"""
import random

import pytest
from cryptography import x509 as jx509
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import Bundle as JBundle
from fabric_mod_tpu.channelconfig.configtx import config_from_block as j_cfb
from fabric_mod_tpu.gossip import discovery as jdiscovery
from fabric_mod_tpu.gossip import election as jelection
from fabric_mod_tpu.gossip import identity as jidentity
from fabric_mod_tpu.gossip import msgstore as jmsgstore
from fabric_mod_tpu.gossip import protoext as jprotoext
from fabric_mod_tpu.gossip import state as jstate
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.gossip import (discovery, election, identity,
                                         msgstore, protoext, state)
from fabric_mod_tpu_torch.msp.identities import (SigningIdentity,
                                                 deserialize_cert)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils import fixtures

SEED = 11


@pytest.fixture(scope="module")
def world():
    """(material, port signers, reference signers, port MSP manager,
    reference MSP manager)."""
    mat = fixtures.make_network_material(SEED, gossip_peers=3)
    pems = list(mat.gossip_peers) + [mat.client]
    csp, jcsp = sw.SwCSP(), JSwCSP()
    port = [SigningIdentity(mspid, deserialize_cert(cert), key, csp)
            for mspid, cert, key in pems]
    ref = [JSigner(mspid, jx509.load_pem_x509_certificate(cert), key, jcsp)
           for mspid, cert, key in pems]
    cid, config = config_from_block(m.Block.decode(mat.genesis))
    jcid, jconfig = j_cfb(jm.Block.decode(mat.genesis))
    return (mat, port, ref, Bundle(cid, config, csp).msp_manager,
            JBundle(jcid, jconfig, jcsp).msp_manager)


def test_pki_ids_agree(world):
    _, port, ref, _, _ = world
    for p, j in zip(port, ref):
        assert p.serialize() == j.serialize()
        assert identity.pki_id_of(p.serialize()) == \
            jidentity.pki_id_of(j.serialize())


def _envelopes(signers, msgs, sign_message):
    """Each signer's alive message and data message, signed with the
    package's `sign_message`, as envelope bytes."""
    out = []
    for i, s in enumerate(signers):
        member = msgs.GossipMember(endpoint=f"p{i}:7051",
                                   pki_id=b"\x01" * 32)
        alive = msgs.GossipMessage(alive_msg=msgs.AliveMessage(
            membership=member, timestamp=msgs.PeerTime(inc_num=7,
                                                       seq_num=i + 1),
            identity=s.serialize()))
        data = msgs.GossipMessage(nonce=1000 + i, channel=b"testchannel",
                                  data_msg=msgs.DataMessage(
                                      payload=msgs.GossipPayload(
                                          seq_num=i, data=b"block%d" % i)))
        out += [sign_message(alive, s).encode(),
                sign_message(data, s).encode()]
    return out


def _variants(raw, msgs):
    """The envelope, its payload tampered, its signature tampered, and
    its signature dropped."""
    env = msgs.GossipEnvelope.decode(raw)
    flip = bytearray(env.payload)
    flip[len(flip) // 2] ^= 0x01
    sig = bytearray(env.signature)
    sig[-1] ^= 0x01
    return [env,
            msgs.GossipEnvelope(payload=bytes(flip), signature=env.signature),
            msgs.GossipEnvelope(payload=env.payload, signature=bytes(sig)),
            msgs.GossipEnvelope(payload=env.payload, signature=b"")]


def test_verify_envelope_verdicts_cross(world):
    """Envelopes of both packages, crossed as bytes, get the same verdict
    from both packages' mappers; the last signer (the client) is unknown
    to the mappers, so its envelopes fail everywhere."""
    _, port, ref, mgr, jmgr = world
    mapper = identity.IdentityMapper(mgr, sw.SwVerifier())
    jmapper = jidentity.IdentityMapper(jmgr)
    for p in port[:-1]:
        mapper.put(p.serialize())
        jmapper.put(p.serialize())
    raws = (_envelopes(port, m, protoext.sign_message)
            + _envelopes(ref, jm, jprotoext.sign_message))
    verdicts = []
    for k, raw in enumerate(raws):
        signer = (port + ref)[k // 2]
        pid = identity.pki_id_of(signer.serialize())
        for env, jenv in zip(_variants(raw, m), _variants(raw, jm)):
            got = protoext.verify_envelope(
                env, lambda pl, sg: mapper.verify(pid, pl, sg))
            jgot = jprotoext.verify_envelope(
                jenv, lambda pl, sg: jmapper.verify(pid, pl, sg))
            assert (got is None) == (jgot is None)
            if got is not None:
                assert got.encode() == jgot.encode()
            verdicts.append(got is not None)
    # per signer: 2 envelopes x (intact, payload, signature, no signature)
    assert verdicts == ([True, False, False, False] * 2 * 3
                        + [False] * 8) * 2


def _block(msgs, num):
    return msgs.Block(header=msgs.BlockHeader(number=num,
                                              data_hash=b"%d" % num),
                      data=msgs.BlockData(data=[b"tx%d" % num]))


def test_payloads_buffer_same_sequence(world):
    rng = random.Random(SEED)
    buf, jbuf = state.PayloadsBuffer(1), jstate.PayloadsBuffer(1)
    log, jlog = [], []
    for _ in range(400):
        op = rng.choice(("push", "push", "push", "pop", "resync",
                         "missing"))
        if op == "push":
            num = rng.randrange(0, 40)
            log.append(buf.push(_block(m, num)))
            jlog.append(jbuf.push(_block(jm, num)))
        elif op == "pop":
            got, jgot = buf.pop_in_order(), jbuf.pop_in_order()
            log.append(None if got is None else got.encode())
            jlog.append(None if jgot is None else jgot.encode())
        elif op == "resync":
            to = rng.randrange(0, 40)
            buf.resync(to)
            jbuf.resync(to)
        else:
            log.append(buf.missing_range())
            jlog.append(jbuf.missing_range())
        log.append(buf.next_seq)
        jlog.append(jbuf.next_seq)
    assert log == jlog
    assert any(isinstance(x, range) for x in log)
    assert any(isinstance(x, bytes) for x in log)


def test_ttl_store_same_sequence():
    rng = random.Random(SEED)
    store = msgstore.TTLMessageStore(ttl_s=8.0, n_buckets=4, max_entries=20)
    jstore = jmsgstore.TTLMessageStore(ttl_s=8.0, n_buckets=4,
                                       max_entries=20)
    now, got, jgot = 0.0, [], []
    for _ in range(600):
        now += rng.choice((0.0, 0.1, 0.5, 3.0))
        key = rng.randrange(0, 30)
        got.append((store.check_and_add(key, now=now), len(store)))
        jgot.append((jstore.check_and_add(key, now=now), len(jstore)))
    assert got == jgot
    assert {g[0] for g in got} == {True, False}


class _Comm:
    def __init__(self):
        self.sent = []

    def broadcast(self, endpoints, msg):
        self.sent.append((sorted(endpoints), msg.encode()))
        return len(endpoints)


def test_membership_and_election_same_sequence():
    """One seeded sequence of alive messages (fresh and stale), clock
    steps and expiry checks through both packages' Discovery; after each
    step both elections tick over the view.  Views, expiries, verdicts
    and on_change transitions must agree."""
    rng = random.Random(SEED)
    pids = [bytes([i]) * 32 for i in range(8)]
    me = pids[3]
    clock = [100.0]
    views, transitions = [], ([], [])
    comms = (_Comm(), _Comm())
    discs = [mod.Discovery(msgs.GossipMember(endpoint="self", pki_id=me),
                           b"id", comm, expiry_s=5.0,
                           clock=lambda: clock[0])
             for mod, msgs, comm in ((discovery, m, comms[0]),
                                     (jdiscovery, jm, comms[1]))]
    elections = [mod.LeaderElectionService(
        me, lambda d=d: [mb.pki_id for mb in d.alive_members()],
        on_change=out.append)
        for mod, d, out in ((election, discs[0], transitions[0]),
                            (jelection, discs[1], transitions[1]))]
    static = (election.LeaderElectionService(me, lambda: pids, static=True),
              jelection.LeaderElectionService(me, lambda: pids, static=True))
    seqs = {}
    for step in range(300):
        op = rng.choice(("alive", "alive", "alive", "stale", "time",
                         "expire", "send"))
        if op in ("alive", "stale"):
            pid = rng.choice(pids)
            seqs[pid] = seqs.get(pid, 0) + (1 if op == "alive" else 0)
            out = [d.handle_alive(pid, msgs.AliveMessage(
                membership=msgs.GossipMember(endpoint=pid.hex()[:4],
                                             pki_id=pid),
                timestamp=msgs.PeerTime(inc_num=1, seq_num=seqs[pid])))
                for d, msgs in zip(discs, (m, jm))]
        elif op == "time":
            clock[0] += rng.choice((0.5, 2.0, 4.0))
            out = None
        elif op == "expire":
            out = [sorted(d.tick_check_alive()) for d in discs]
        else:
            out = [d.tick_send_alive() for d in discs]
        views.append((out[0] == out[1] if out else True,
                      sorted(mb.pki_id for mb in discs[0].alive_members()) ==
                      sorted(mb.pki_id for mb in discs[1].alive_members()),
                      elections[0].tick() == elections[1].tick(),
                      static[0].tick() == static[1].tick() is True))
    assert all(all(v) for v in views), views
    assert transitions[0] == transitions[1]
    assert True in transitions[0] and False in transitions[0]
    assert comms[0].sent == comms[1].sent and comms[0].sent
