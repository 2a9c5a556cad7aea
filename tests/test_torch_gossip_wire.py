"""Gossip over the wire with the authenticated handshake: the port's
GRPCGossipNetwork and GossipAuth (fabric_mod_tpu_torch/gossip/comm.py)
against the reference's (fabric_mod_tpu/gossip/comm.py, over grpcio).

Each scenario of tests/test_gossip_auth.py runs on both packages, each
with its own CAs, TLS CA, MSP manager and identity mappers, and must
end the same way:
- a handshaked send is delivered and attributed to the sender's PKI-ID;
- a sender that handshakes as OrgA but claims OrgB's PKI-ID is dropped;
- a handshake signed over another TLS certificate's digest, replayed
  on the attacker's own connection, is refused ("tls binding mismatch");
- a Message call without a handshake token is dropped;
- a receiver that lost its sessions answers NACK, and the sender
  re-handshakes and redelivers.
The port's fault point `gossip.comm.send`: one injected failure costs a
retry, not the message; failures on every attempt (1 + send_retries)
drop that message and the next one is delivered.
"""
import base64
import json
import time
import types

import pytest
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.comm.grpc_comm import GRPCClient as JClient
from fabric_mod_tpu.comm.tls import TlsCA as JTlsCA
from fabric_mod_tpu.gossip import comm as jcomm
from fabric_mod_tpu.gossip.identity import IdentityMapper as JMapper
from fabric_mod_tpu.gossip.identity import pki_id_of as j_pki_id_of
from fabric_mod_tpu.msp import ca as jcalib
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.msp.mspimpl import Msp as JMsp
from fabric_mod_tpu.msp.mspimpl import MspManager as JMspManager

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient
from fabric_mod_tpu_torch.comm.tls import TlsCA
from fabric_mod_tpu_torch.gossip import comm
from fabric_mod_tpu_torch.gossip.identity import IdentityMapper, pki_id_of
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.msp.identities import SigningIdentity
from fabric_mod_tpu_torch.msp.mspimpl import Msp, MspManager

PKGS = {
    "ref": types.SimpleNamespace(
        SwCSP=JSwCSP, Client=JClient, TlsCA=JTlsCA, comm=jcomm,
        Mapper=JMapper, pki_id_of=j_pki_id_of, calib=jcalib,
        Signer=JSigner, Msp=JMsp, MspManager=JMspManager,
        ca=lambda name, org: jcalib.CA(name, org)),
    "port": types.SimpleNamespace(
        SwCSP=SwCSP, Client=GRPCClient, TlsCA=TlsCA, comm=comm,
        Mapper=IdentityMapper, pki_id_of=pki_id_of, calib=calib,
        Signer=SigningIdentity, Msp=Msp, MspManager=MspManager,
        ca=lambda name, org: calib.CA(name, org, seed=b"gossip-wire")),
}


def _crypto(p):
    csp = p.SwCSP()
    org_cas = {org: p.ca(f"ca.{org.lower()}", org) for org in ("OrgA",
                                                               "OrgB")}
    msp_mgr = p.MspManager([p.Msp(org, csp, [ca.cert])
                            for org, ca in org_cas.items()])
    signers = {}
    for org, ca in org_cas.items():
        cert, key = ca.issue(f"peer.{org.lower()}", org, ous=["peer"])
        signers[org] = p.Signer(org, cert, p.calib.key_pem(key), csp)
    return types.SimpleNamespace(csp=csp, msp_mgr=msp_mgr, tls=p.TlsCA(),
                                 signers=signers)


def _make_net(p, c, org, name, **kw):
    scert, skey = c.tls.issue(f"{name}.gossip",
                              sans=("localhost", "127.0.0.1"))
    ccert, ckey = c.tls.issue(f"{name}.client", server=False)
    mapper = p.Mapper(c.msp_mgr, None)
    signer = c.signers[org]
    auth = p.comm.GossipAuth(identity=signer.serialize(),
                             sign=signer.sign_message, validate=mapper.put,
                             verify=lambda pki, data, sig:
                                 mapper.verify(pki, data, sig))
    net = p.comm.GRPCGossipNetwork("127.0.0.1:0", server_cert=scert,
                                   server_key=skey, client_ca=c.tls.cert_pem,
                                   client_cert=ccert, client_key=ckey,
                                   auth=auth, **kw)
    net.start()
    return net, (ccert, ckey)


def _wait_for(got, n, t=10.0):
    deadline = time.time() + t
    while time.time() < deadline and len(got) < n:
        time.sleep(0.02)


@pytest.fixture(params=sorted(PKGS))
def side(request):
    p = PKGS[request.param]
    nets = []

    def make(c, org, name, **kw):
        net, pems = _make_net(p, c, org, name, **kw)
        nets.append(net)
        return net, pems
    yield types.SimpleNamespace(p=p, c=_crypto(p), make=make)
    for net in nets:
        net.stop()


def test_handshaked_gossip_delivers_and_attributes(side):
    net_a, _ = side.make(side.c, "OrgA", "a")
    net_b, _ = side.make(side.c, "OrgB", "b")
    got = []
    net_b.register(net_b.listen_endpoint,
                   lambda pki, env: got.append((pki, env)))
    pki_a = side.p.pki_id_of(side.c.signers["OrgA"].serialize())
    assert net_a.send("a", pki_a, net_b.listen_endpoint, b"hello")
    _wait_for(got, 1)
    assert got == [(pki_a, b"hello")]


def test_claimed_pki_must_match_handshake_identity(side):
    net_a, _ = side.make(side.c, "OrgA", "a")
    net_b, _ = side.make(side.c, "OrgB", "b")
    got = []
    net_b.register(net_b.listen_endpoint,
                   lambda pki, env: got.append((pki, env)))
    pki_b = side.p.pki_id_of(side.c.signers["OrgB"].serialize())
    net_a.send("a", pki_b, net_b.listen_endpoint, b"forged")
    time.sleep(1.0)
    assert got == []


def test_replayed_handshake_on_other_tls_session_rejected(side):
    p, c = side.p, side.c
    net_b, _ = side.make(c, "OrgB", "b")
    atk_cert, atk_key = c.tls.issue("attacker.client", server=False)
    victim_cert, _ = c.tls.issue("victim.client", server=False)
    victim_tls_hash = p.comm._pem_cert_der_hash(victim_cert)
    client = p.Client(net_b.listen_endpoint, server_root_pem=c.tls.cert_pem,
                      client_cert_pem=atk_cert, client_key_pem=atk_key)
    try:
        hello = json.loads(client.unary(
            "Gossip", "Connect", json.dumps({"phase": "hello"}).encode(),
            timeout=5))
        nonce = base64.b64decode(hello["nonce"])
        sig = c.signers["OrgB"].sign_message(
            p.comm._HSK_CTX + nonce + victim_tls_hash)
        resp = json.loads(client.unary("Gossip", "Connect", json.dumps({
            "phase": "auth", "nonce": hello["nonce"],
            "identity": base64.b64encode(
                c.signers["OrgB"].serialize()).decode(),
            "tls": base64.b64encode(victim_tls_hash).decode(),
            "sig": base64.b64encode(sig).decode()}).encode(), timeout=5))
        assert resp == {"error": "tls binding mismatch"}
    finally:
        client.close()


def test_unauthenticated_message_dropped(side):
    p, c = side.p, side.c
    net_b, (ccert, ckey) = side.make(c, "OrgB", "b")
    got = []
    net_b.register(net_b.listen_endpoint, lambda pki, env: got.append(env))
    client = p.Client(net_b.listen_endpoint, server_root_pem=c.tls.cert_pem,
                      client_cert_pem=ccert, client_key_pem=ckey)
    try:
        resp = client.unary("Gossip", "Message", json.dumps({
            "dst": net_b.listen_endpoint,
            "pki": base64.b64encode(b"x").decode(),
            "env": base64.b64encode(b"evil").decode()}).encode(), timeout=5)
        assert resp == b"NACK"
        time.sleep(0.3)
        assert got == []
    finally:
        client.close()


def test_lost_session_triggers_rehandshake(side):
    net_a, _ = side.make(side.c, "OrgA", "a")
    net_b, _ = side.make(side.c, "OrgB", "b")
    got = []
    net_b.register(net_b.listen_endpoint, lambda pki, env: got.append(env))
    pki_a = side.p.pki_id_of(side.c.signers["OrgA"].serialize())
    net_a.send("a", pki_a, net_b.listen_endpoint, b"one")
    _wait_for(got, 1)
    assert got == [b"one"]
    net_b._sessions.clear()               # the receiver "restarted"
    net_a.send("a", pki_a, net_b.listen_endpoint, b"two")
    _wait_for(got, 2)
    assert got == [b"one", b"two"]


def test_send_seam_costs_a_retry_then_a_message():
    p = PKGS["port"]
    c = _crypto(p)
    net_a, _ = _make_net(p, c, "OrgA", "a")
    net_b, _ = _make_net(p, c, "OrgB", "b")
    try:
        got = []
        net_b.register(net_b.listen_endpoint,
                       lambda pki, env: got.append(env))
        pki_a = pki_id_of(c.signers["OrgA"].serialize())
        once = faults.FaultPlan().add("gossip.comm.send", nth=1)
        with faults.active(once):
            net_a.send("a", pki_a, net_b.listen_endpoint, b"retried")
            _wait_for(got, 1)
        assert got == [b"retried"] and once.fires("gossip.comm.send") == 1
        every = faults.FaultPlan().add("gossip.comm.send", nth=1,
                                       times=comm.SEND_RETRIES + 1)
        with faults.active(every):
            net_a.send("a", pki_a, net_b.listen_endpoint, b"lost")
            deadline = time.time() + 10
            while every.calls("gossip.comm.send") < comm.SEND_RETRIES + 1:
                assert time.time() < deadline
                time.sleep(0.02)
            net_a.send("a", pki_a, net_b.listen_endpoint, b"next")
            _wait_for(got, 2)
        assert got == [b"retried", b"next"]
        assert every.fires("gossip.comm.send") == comm.SEND_RETRIES + 1
    finally:
        net_a.stop()
        net_b.stop()
