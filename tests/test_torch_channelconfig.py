"""Channel config and the channel policy tree, port against reference.

From the same CA certificates both packages' `standard_network` must
build the same `Config`; the same genesis block gives both `Bundle`s
policy trees whose verdicts on /Channel/Application/Endorsement, the
Writers policies and /Channel/Orderer/BlockValidation agree for the
same signed-data sets (the port both through its closures and through
the tensor-policy session), under-signed and tampered sets included;
and a config update computed and signed by the reference
(channelconfig/update.py) gives the same `propose_config_update` bytes
in both packages, and the same refusal when it is under-signed.

The material is the port's seeded fixture; every certificate, key and
block crosses as bytes.  Everything here verifies on the host: no
device path and no XLA compile."""
import numpy as np
import pytest
import torch

from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import (
    Bundle as JBundle, ConfigTxError as JConfigTxError, compute_update,
    extract_config_update as j_extract, genesis as jgenesis,
    propose_config_update as j_propose, signed_update_envelope)
from fabric_mod_tpu.channelconfig.bundle import (
    APPLICATION, groups_of, policies_of, set_group, set_policy)
from fabric_mod_tpu.channelconfig.configtx import config_from_block as j_cfb
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.policy.cauthdsl import BatchCollector as JBatchCollector
from fabric_mod_tpu.policy.tensorpolicy import TensorSession as JTensorSession
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos.protoutil import SignedData as JSignedData
from cryptography import x509 as jx509

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.channelconfig import (
    Bundle, ConfigTxError, config_from_block, extract_config_update, genesis,
    propose_config_update)
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.policy import BatchCollector, tensorpolicy
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos.protoutil import SignedData
from fabric_mod_tpu_torch.utils import fixtures

CHANNEL = "cfgchannel"


@pytest.fixture(scope="module")
def world():
    mat = fixtures.make_network_material(
        7, channel_id=CHANNEL, max_message_count=8, batch_timeout="60s")
    csp = sw.SwCSP()
    signers = {"client": mat.client, "orderer": mat.orderer,
               **{f"peer.{o}": p for o, p in mat.peers.items()},
               **{f"admin.{o}": p for o, p in mat.admins.items()}}
    return mat, {name: _signer(csp, p) for name, p in signers.items()}


def _ref_signer(pems):
    mspid, cert_pem, key_pem = pems
    return JSigner(mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem,
                   JSwCSP())


def _bundles(mat):
    block = m.Block.decode(mat.genesis)
    cid, cfg = config_from_block(block)
    jcid, jcfg = j_cfb(jm.Block.decode(mat.genesis))
    return Bundle(cid, cfg, sw.SwCSP()), JBundle(jcid, jcfg, JSwCSP())


def test_genesis_config_equals_reference(world):
    mat, _ = world
    orgs = {org: [pem] for org, pem in mat.ca_pems.items()}
    orderer = {"OrdererOrg": [mat.orderer_ca_pem]}
    kw = dict(max_message_count=8, batch_timeout="60s",
              preferred_max_bytes=16 * 1024 * 1024)
    mine = config_from_block(genesis.standard_network(CHANNEL, orgs, orderer,
                                                      **kw))
    ref = j_cfb(jgenesis.standard_network(CHANNEL, orgs, orderer, **kw))
    assert mine[0] == ref[0] == CHANNEL
    assert mine[1].encode() == ref[1].encode()
    # and the fixture's genesis carries the same Config as the
    # reference would build from its certificates
    ref_default = j_cfb(jgenesis.standard_network(
        CHANNEL, orgs, orderer, max_message_count=8, batch_timeout="60s"))
    assert config_from_block(m.Block.decode(mat.genesis))[1].encode() == \
        ref_default[1].encode()


# (policy path, [(signer name, tamper)]) -> the signed-data sets; a
# tampered signature has one bit of r flipped
SETS = [
    ("/Channel/Application/Endorsement",
     [("peer.Org1", False), ("peer.Org2", False)]),
    ("/Channel/Application/Endorsement",
     [("peer.Org1", False), ("peer.Org2", False), ("peer.Org3", False)]),
    ("/Channel/Application/Endorsement", [("peer.Org3", False)]),
    ("/Channel/Application/Endorsement",
     [("peer.Org1", False), ("peer.Org2", True)]),
    ("/Channel/Application/Endorsement",
     [("peer.Org1", False), ("peer.Org1", False)]),
    ("/Channel/Application/Endorsement",
     [("peer.Org2", False), ("client", False)]),
    ("/Channel/Application/Writers", [("client", False)]),
    ("/Channel/Application/Writers", [("client", True)]),
    ("/Channel/Application/Writers", [("orderer", False)]),
    ("/Channel/Writers", [("orderer", False)]),
    ("/Channel/Writers", [("admin.Org3", False)]),
    ("/Channel/Orderer/BlockValidation", [("orderer", False)]),
    ("/Channel/Orderer/BlockValidation", [("orderer", True)]),
    ("/Channel/Orderer/BlockValidation", [("peer.Org1", False)]),
    ("/Channel/Application/Admins",
     [("admin.Org1", False), ("admin.Org2", False)]),
    ("/Channel/Application/Admins", [("admin.Org1", False)]),
]


def _signed_sets(signers):
    out = []
    for i, (_path, who) in enumerate(SETS):
        data = b"signed-data|%d" % i
        sds = []
        for name, tamper in who:
            s = signers[name]
            sig = s.sign_message(data)
            sds.append((data, s.serialize(),
                        fixtures._flip(sig) if tamper else sig))
        out.append(sds)
    return out


def test_policy_tree_verdicts_equal_reference(world):
    mat, signers = world
    bundle, jbundle = _bundles(mat)
    sets = _signed_sets(signers)
    want = [jbundle.policy(path).evaluate_signed_data(
        [JSignedData(data=d, identity=i, signature=s) for d, i, s in sds])
        for (path, _), sds in zip(SETS, sets)]
    assert want == [True, True, False, False, False, False, True, False,
                    False, True, True, True, False, False, True, False]
    # the closures, one host evaluation per set
    got = [bundle.policy(path).evaluate_signed_data(
        [SignedData(data=d, identity=i, signature=s) for d, i, s in sds])
        for (path, _), sds in zip(SETS, sets)]
    assert got == want
    # the tensor session: every set staged into one collector, one
    # verify, one evaluator pass over a CPU mask; the reference's
    # session over a host mask (its numpy interpreter, no XLA) beside it
    collector = BatchCollector()
    session = tensorpolicy.TensorSession(bundle.msp_manager, bundle.sequence)
    pendings = [bundle.policy(path).prepare(
        [SignedData(data=d, identity=i, signature=s) for d, i, s in sds],
        collector, session) for (path, _), sds in zip(SETS, sets)]
    session.finalize()
    mask = torch.from_numpy(sw.SwVerifier().verify_many(collector.items))
    session.attach_mask(mask)
    assert [p.finish(mask.numpy()) for p in pendings] == want
    jcollector = JBatchCollector()
    jsession = JTensorSession(jbundle.msp_manager, jbundle.sequence)
    jpendings = [jbundle.policy(path).prepare(
        [JSignedData(data=d, identity=i, signature=s) for d, i, s in sds],
        jcollector, jsession) for (path, _), sds in zip(SETS, sets)]
    jsession.finalize()
    jmask = np.asarray(JSwCSP().verify_batch(jcollector.items), bool)
    jsession.attach_mask(jmask)
    assert [p.finish(jmask) for p in jpendings] == want
    assert len(session) == len(jsession) > 0
    assert session.fallbacks == jsession.fallbacks


def _endorsement_update(mat, rule):
    """The reference's config update flipping the application
    Endorsement meta policy to `rule`."""
    _, jcfg = j_cfb(jm.Block.decode(mat.genesis))
    desired = jm.ConfigGroup.decode(jcfg.channel_group.encode())
    app = groups_of(desired)[APPLICATION]
    pol = policies_of(app)["Endorsement"]
    pol.policy = jm.Policy(
        type=jm.PolicyType.IMPLICIT_META,
        value=jm.ImplicitMetaPolicy(sub_policy="Endorsement",
                                    rule=rule).encode())
    set_policy(app, "Endorsement", pol)
    set_group(desired, APPLICATION, app)
    return compute_update(CHANNEL, jcfg, desired)


@pytest.mark.parametrize("admins, accepted", [
    (("Org1", "Org2"), True),
    (("Org3",), False),
])
def test_config_update_proposal_equals_reference(world, admins, accepted):
    mat, _ = world
    bundle, jbundle = _bundles(mat)
    env = signed_update_envelope(
        CHANNEL, _endorsement_update(mat, jm.ImplicitMetaRule.ALL),
        [_ref_signer(mat.admins[o]) for o in admins])
    jcue = j_extract(env)
    cue = extract_config_update(m.Envelope.decode(env.encode()))
    if not accepted:
        with pytest.raises(JConfigTxError):
            j_propose(jbundle, jcue)
        with pytest.raises(ConfigTxError):
            propose_config_update(bundle, cue)
        return
    want = j_propose(jbundle, jcue)
    got = propose_config_update(bundle, cue)
    assert got.sequence == want.sequence == 1
    assert got.encode() == want.encode()
    # the new bundle's Endorsement now needs every org
    nb, jnb = Bundle(CHANNEL, got, sw.SwCSP()), JBundle(CHANNEL, want, JSwCSP())
    assert np.array_equal(
        [nb.policy("/Channel/Application/Endorsement").threshold],
        [jnb.policy("/Channel/Application/Endorsement").threshold])


def test_policy_from_proto_equals_reference(world):
    """Each org's Endorsement policy proto of the genesis config, through
    both packages' `policy_from_proto`, gives the same verdicts on the
    org's own peer, another org's peer and a tampered signature; the
    application group's implicit meta policy is refused by both (it
    needs the tree: PolicyManager.resolve_implicit_meta)."""
    from fabric_mod_tpu.policy import PolicyError as JPolicyError
    from fabric_mod_tpu.policy import policy_from_proto as j_from_proto
    from fabric_mod_tpu_torch.channelconfig.bundle import (
        groups_of as p_groups, policies_of as p_policies)
    from fabric_mod_tpu_torch.policy import PolicyError, policy_from_proto
    mat, signers = world
    bundle, jbundle = _bundles(mat)
    app = p_groups(bundle.config.channel_group)[APPLICATION]
    japp = groups_of(jbundle.config.channel_group)[APPLICATION]
    verdicts = []
    for org in sorted(mat.ca_pems):
        pol = policy_from_proto(
            p_policies(p_groups(app)[org])["Endorsement"].policy,
            bundle.msp_manager)
        jpol = j_from_proto(
            policies_of(groups_of(japp)[org])["Endorsement"].policy,
            jbundle.msp_manager)
        for name, tamper in ((f"peer.{org}", False), (f"peer.{org}", True),
                             ("peer.Org2" if org != "Org2" else "peer.Org1",
                              False)):
            s = signers[name]
            data = b"from-proto|" + org.encode()
            sig = s.sign_message(data)
            sig = fixtures._flip(sig) if tamper else sig
            got = pol.evaluate_signed_data(
                [SignedData(data=data, identity=s.serialize(), signature=sig)])
            want = jpol.evaluate_signed_data(
                [JSignedData(data=data, identity=s.serialize(),
                             signature=sig)])
            assert got == want
            verdicts.append(got)
    assert verdicts == [True, False, False] * 3
    with pytest.raises(PolicyError):
        policy_from_proto(p_policies(app)["Endorsement"].policy,
                          bundle.msp_manager)
    with pytest.raises(JPolicyError):
        j_from_proto(policies_of(japp)["Endorsement"].policy,
                     jbundle.msp_manager)
