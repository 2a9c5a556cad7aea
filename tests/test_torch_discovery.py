"""Service discovery in the port (fabric_mod_tpu_torch/discovery/),
mirroring tests/test_discovery.py's discovery cases and held to the
reference's fabric_mod_tpu/discovery/service.py on the same inputs:

* satisfying sets for the reference test's policy shapes and nested
  ones, equal to the reference's;
* the endorsement descriptors (layouts, usable layouts) after a
  lifecycle deployment and for the implicit-meta MAJORITY default, equal
  to the reference service's on the same config and policies;
* `check_access` verdicts on a mix of valid queries from the three
  orgs, flipped signatures and a non-member org, through the port's
  GpuVerifier (its plain path on the CPU, one coalesced call), equal to
  the reference's host verifier; a second pass answered from the auth
  cache with no verify call; a bumped config sequence verifies again;
* `config()`, equal to the reference's.
"""
import threading

import pytest
import torch

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.discovery import DiscoveryService
from fabric_mod_tpu_torch.discovery.service import _satisfying_sets
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.policy import from_string
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos.protoutil import SignedData
from fabric_mod_tpu_torch.utils import fixtures

SHAPES = (
    "AND('A.peer', 'B.peer')",
    "OR('A.peer', 'B.peer')",
    "OutOf(2, 'A.peer', 'B.peer', 'C.peer')",
    "OR(AND('A.peer', 'B.peer'), 'C.member')",
    "OutOf(2, 'A.peer', AND('B.peer', 'C.peer'), 'A.admin')",
    "AND('A.peer', OR('A.peer', 'B.client'))",
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    root = tmp_path_factory.mktemp("discovery")
    n = e2e.Network(str(root), material=fixtures.make_network_material(
        61, max_message_count=4, batch_timeout="100ms"),
        verifier=sw.SwVerifier())
    policy = m.ApplicationPolicy(signature_policy=from_string(
        "AND('Org1.peer', 'Org3.peer')")).encode()
    assert n.deploy_chaincode("cc2", "1.0", 1, policy=policy) == 3
    yield n
    n.close()


def _members(pkg, *orgs_counts):
    return {org: [pkg.GossipMember(endpoint=f"{org.lower()}-p{i}:7051",
                                   pki_id=b"%s%d" % (org.encode(), i))
                  for i in range(count)]
            for org, count in orgs_counts}


def _reference_service(net, membership, vinfo=None):
    """The reference's DiscoveryService over the port network's current
    config, its vinfo answering with the port's policy bytes, and its
    default (host software) verifier."""
    from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
    from fabric_mod_tpu.channelconfig.bundle import Bundle as JBundle
    from fabric_mod_tpu.discovery import DiscoveryService as JDiscovery
    from fabric_mod_tpu.protos import messages as jm
    bundle = net.channel.bundle()
    jbundle = JBundle(bundle.channel_id,
                      jm.Config.decode(bundle.config.encode()), JSwCSP())
    return JDiscovery(lambda: jbundle, vinfo or net.channel._vinfo,
                      lambda: _members(jm, *membership))


@pytest.mark.parametrize("shape", SHAPES)
def test_satisfying_sets_equal_the_reference(shape):
    from fabric_mod_tpu.discovery.service import \
        _satisfying_sets as j_satisfying_sets
    from fabric_mod_tpu.policy import from_string as j_from_string
    env, jenv = from_string(shape), j_from_string(shape)
    assert env.encode() == jenv.encode()
    got = _satisfying_sets(env.rule, env.identities)
    assert got == j_satisfying_sets(jenv.rule, jenv.identities)
    assert got


def test_reference_shapes_give_the_reference_test_sets():
    env = from_string(SHAPES[0])
    assert _satisfying_sets(env.rule, env.identities) == [{0: 1, 1: 1}]
    env = from_string(SHAPES[1])
    assert {tuple(s.items()) for s in _satisfying_sets(
        env.rule, env.identities)} == {((0, 1),), ((1, 1),)}
    env = from_string(SHAPES[2])
    assert len(_satisfying_sets(env.rule, env.identities)) == 3


@pytest.mark.parametrize("chaincode,want", [
    # the implicit-meta MAJORITY default of 3 orgs: 2-of-3
    ("mycc", [{"Org1": 1, "Org2": 1}, {"Org1": 1, "Org3": 1},
              {"Org2": 1, "Org3": 1}]),
    # the lifecycle-deployed definition's policy
    ("cc2", [{"Org1": 1, "Org3": 1}]),
])
def test_descriptors_equal_the_reference(net, chaincode, want):
    membership = (("Org1", 2), ("Org2", 1), ("Org3", 0))
    svc = DiscoveryService(net.channel.bundle, net.channel._vinfo,
                           lambda: _members(m, *membership),
                           gpu.GpuVerifier(device="cpu").verify_many)
    desc = svc.peers_for_endorsement(chaincode)
    assert [lo.quantities_by_org for lo in desc.layouts] == want
    jdesc = _reference_service(net, membership).peers_for_endorsement(
        chaincode)
    assert [lo.quantities_by_org for lo in desc.layouts] == \
        [lo.quantities_by_org for lo in jdesc.layouts]
    assert [lo.quantities_by_org for lo in desc.usable_layouts()] == \
        [lo.quantities_by_org for lo in jdesc.usable_layouts()] == \
        [lo for lo in want if "Org3" not in lo]


def test_config_equals_the_reference(net):
    svc = DiscoveryService(net.channel.bundle, net.channel._vinfo,
                           lambda: {},
                           gpu.GpuVerifier(device="cpu").verify_many)
    conf = svc.config()
    assert set(conf["msps"]) == {"Org1", "Org2", "Org3", "OrdererOrg"}
    assert conf == _reference_service(net, ()).config()


def test_verify_many_is_required(net):
    # None would reach the policy layer as its host verifier
    with pytest.raises(TypeError):
        DiscoveryService(net.channel.bundle, net.channel._vinfo, lambda: {})
    with pytest.raises(ValueError, match="verify_many"):
        DiscoveryService(net.channel.bundle, net.channel._vinfo, lambda: {},
                         None)


class _Bumped:
    """The channel's bundle with its config sequence one higher (what a
    committed config update does to the auth cache's key)."""

    def __init__(self, bundle):
        self._bundle = bundle
        self.sequence = bundle.sequence + 1

    def __getattr__(self, name):
        return getattr(self._bundle, name)


def _queries(net):
    """(SignedData, expected verdict): valid queries of the three orgs'
    client, peers and admins, the same with one signature bit flipped,
    and two from an org outside the channel."""
    signers = [net.client] + list(net.peer_signers.values()) + \
        list(net.admins.values())[:1]
    outsider_ca = calib.CA("ca.org9", "Org9", seed=b"outside",
                           now=fixtures.CERT_EPOCH)
    outsiders = []
    for i in range(2):
        cert, key = outsider_ca.issue(f"client{i}@org9", "Org9",
                                      ous=["client"])
        outsiders.append(e2e._signer(
            net.csp, ("Org9", cert.pem(), calib.key_pem(key))))
    out = []
    for i, s in enumerate(signers):
        data = b"discovery-query-%d" % i
        sig = s.sign_message(data)
        out.append((SignedData(data=data, identity=s.serialize(),
                               signature=sig), True))
        if i < 3:
            out.append((SignedData(data=data, identity=s.serialize(),
                                   signature=fixtures._flip(sig)), False))
    for i, s in enumerate(outsiders):
        data = b"outside-query-%d" % i
        out.append((SignedData(data=data, identity=s.serialize(),
                               signature=s.sign_message(data)), False))
    return out


def test_check_access_verdicts_equal_the_reference(net):
    from fabric_mod_tpu.protos.protoutil import SignedData as JSignedData
    queries = _queries(net)
    verifier = gpu.GpuVerifier(device="cpu", cache_size=0)
    calls = []
    inner = verifier.verify_many_async

    def counted(items):
        calls.append(len(items))
        return inner(items)
    verifier.verify_many_async = counted
    service = gpu.BatchingVerifyService(verifier, deadline_s=0.5)
    bundle = [net.channel.bundle()]
    svc = DiscoveryService(lambda: bundle[0], net.channel._vinfo,
                           lambda: {}, verify_many=service.verify_many)

    def run_all():
        got = [None] * len(queries)

        def one(i):
            got[i] = svc.check_access(queries[i][0])
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        return got
    try:
        got = run_all()
        # every member query verified once; the outsiders' identities
        # never reach the verifier
        assert sum(calls) == len(queries) - 2
        assert got == [want for _sd, want in queries]
        jsvc = _reference_service(net, ())
        assert got == [jsvc.check_access(JSignedData(
            data=sd.data, identity=sd.identity, signature=sd.signature))
            for sd, _want in queries]
        # the auth cache answers a second pass without a verify
        first = len(calls)
        assert run_all() == got and len(calls) == first
        # a new config sequence keys the cache afresh
        bundle[0] = _Bumped(bundle[0])
        assert run_all() == got
        assert sum(calls[first:]) == len(queries) - 2
    finally:
        service.close()
