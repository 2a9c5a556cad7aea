"""The chaincode lifecycle, port against reference.

The org-local approval split: a `_lifecycle` tx whose writes are all one
org's `approvals/<cc>/<seq>/<mspid>` keys validates against that org's
/Channel/Application/<org>/Endorsement policy, not against
LifecycleEndorsement (reference: peer/lifecycle.py
`validation_info_for_writes`, txvalidator.py `_resolve_vinfo`).  A block
of approvals built by the JAX package's Network goes through both
packages' TxValidator, on the generic per-tx path (a 3-tx block, under
the batch decoder's 4 rows) and on the columnar path (4 txs), and must
get equal txflags.  Then the reference's tests/test_lifecycle.py cases
on the port's Network, and the ceremony in both packages.
"""
import json
import os

import pytest

from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.peer.lifecycle import LIFECYCLE_NS as J_LIFECYCLE_NS
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert, e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS, approval_key
from fabric_mod_tpu_torch.policy import from_string
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

V = m.TxValidationCode


@pytest.fixture(scope="module")
def ref_net(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE"):
        mp.delenv(knob, raising=False)
    root = tmp_path_factory.mktemp("lifecycle")
    net = JNetwork(os.path.join(str(root), "ref"), max_message_count=25,
                   batch_timeout="60s")
    yield net
    net.close()
    mp.undo()


def _approval_env(net, creator_org, endorsing_org, name=b"newcc"):
    """An approval of (name, 1.0, sequence 1) by `creator_org`'s admin,
    endorsed by `endorsing_org`'s peer (reference endorsers)."""
    sp, prop, _ = jprotoutil.create_chaincode_proposal(
        net.channel_id, J_LIFECYCLE_NS,
        [b"approve", name, b"1.0", b"1", b""], net.admins[creator_org])
    resp = net.endorsers[endorsing_org].process_proposal(sp)
    assert resp.response.status == 200, resp.response.message
    return jprotoutil.create_tx_from_responses(
        prop, [resp], net.admins[creator_org])


def _approval_block(net, n_txs):
    """Org1's and Org2's org-local approvals, Org1's approval endorsed
    by Org2's peer alone, and (4 txs) Org3's approval."""
    envs = [_approval_env(net, "Org1", "Org1"),
            _approval_env(net, "Org2", "Org2"),
            _approval_env(net, "Org1", "Org2"),
            _approval_env(net, "Org3", "Org3")][:n_txs]
    tip = net.ledger.get_block_by_number(net.ledger.height - 1)
    return jprotoutil.new_block(
        net.ledger.height, jprotoutil.block_header_hash(tip.header), envs)


@pytest.mark.parametrize("tensor_policy", [False, True],
                         ids=["closures", "tensor"])
@pytest.mark.parametrize("n_txs", [3, 4], ids=["generic", "columnar"])
def test_org_local_approvals_validate_like_the_reference(
        ref_net, tmp_path, n_txs, tensor_policy):
    """The org-local approvals are VALID against their own org's
    Endorsement policy and the wrongly endorsed one fails it, in both
    packages, on the generic and the columnar path."""
    block = _approval_block(ref_net, n_txs)
    want = [V.VALID, V.VALID, V.ENDORSEMENT_POLICY_FAILURE,
            V.VALID][:n_txs]
    ref_flags = ref_net.channel.validator().validate(
        jm.Block.decode(block.encode()))
    assert list(ref_flags) == want
    pnet = e2e.Network(str(tmp_path), convert.network_material_from_reference(
        ref_net), verifier=sw.SwVerifier(), tensor_policy=tensor_policy)
    try:
        port_flags = pnet.channel.validator().validate(
            m.Block.decode(block.encode()))
    finally:
        pnet.close()
    assert list(port_flags) == list(ref_flags)


# --- the reference's tests/test_lifecycle.py cases, on the port -------------

@pytest.fixture()
def net(tmp_path):
    n = e2e.Network(str(tmp_path), fixtures.make_network_material(
        15, max_message_count=25, batch_timeout="100ms"),
        verifier=sw.SwVerifier())
    yield n
    n.close()


def _approve(net, org, name=b"newcc", version=b"1.0", seq=b"1",
             policy=b""):
    net.invoke([b"approve", name, version, seq, policy],
               endorsing_orgs=[org], chaincode=LIFECYCLE_NS,
               signer=net.admins[org])


def _query(net, args, org="Org1"):
    """A lifecycle query through an endorser: the response payload."""
    sp, _prop, _txid = protoutil.create_chaincode_proposal(
        net.channel_id, LIFECYCLE_NS, args, net.client)
    resp = net.endorsers[org].process_proposal(sp)
    assert resp.response.status == 200, resp.response.message
    return resp.response.payload


def _all_valid(block):
    return all(f == V.VALID for f in protoutil.block_txflags(block))


def test_commit_requires_majority_approvals(net):
    """1 of 3 approvals: the commit fails simulation; 2 of 3: it commits
    VALID."""
    _approve(net, "Org1")
    assert net.pump_committed(1) == 1
    sp, _p, _t = protoutil.create_chaincode_proposal(
        net.channel_id, LIFECYCLE_NS,
        [b"commit", b"newcc", b"1.0", b"1", b""], net.client)
    resp = net.endorsers["Org1"].process_proposal(sp)
    assert resp.response.status == 500
    assert "approvals" in resp.response.message
    _approve(net, "Org2")
    assert net.pump_committed(2) == 2
    net.invoke([b"commit", b"newcc", b"1.0", b"1", b""],
               chaincode=LIFECYCLE_NS)
    assert net.pump_committed(3) == 3
    assert _all_valid(net.ledger.get_block_by_number(net.ledger.height - 1))
    d = m.ChaincodeDefinition.decode(_query(net, [b"query", b"newcc"]))
    assert d.sequence == 1 and d.version == "1.0"


def test_checkcommitreadiness_reflects_pending_orgs(net):
    _approve(net, "Org2")
    assert net.pump_committed(1) == 1
    ready = json.loads(_query(net, [
        b"checkcommitreadiness", b"newcc", b"1.0", b"1", b""]))
    assert ready == {"Org1": False, "Org2": True, "Org3": False}
    _approve(net, "Org3")
    assert net.pump_committed(2) == 2
    ready = json.loads(_query(net, [
        b"checkcommitreadiness", b"newcc", b"1.0", b"1", b""]))
    assert ready == {"Org1": False, "Org2": True, "Org3": True}


def test_approval_binds_to_exact_parameters(net):
    """An approval of (1.0, policy A) is not one of (1.0, policy B)."""
    pol_a = m.ApplicationPolicy(signature_policy=from_string(
        "OR('Org1.peer')")).encode()
    pol_b = m.ApplicationPolicy(signature_policy=from_string(
        "OR('Org2.peer')")).encode()
    _approve(net, "Org1", policy=pol_a)
    _approve(net, "Org2", policy=pol_a)
    assert net.pump_committed(2) == 2
    ready = json.loads(_query(net, [
        b"checkcommitreadiness", b"newcc", b"1.0", b"1", pol_b]))
    assert ready == {"Org1": False, "Org2": False, "Org3": False}
    sp, _p, _t = protoutil.create_chaincode_proposal(
        net.channel_id, LIFECYCLE_NS,
        [b"commit", b"newcc", b"1.0", b"1", pol_b], net.client)
    assert net.endorsers["Org1"].process_proposal(sp).response.status == 500
    net.invoke([b"commit", b"newcc", b"1.0", b"1", pol_a],
               chaincode=LIFECYCLE_NS)
    assert net.pump_committed(3) == 3
    assert _all_valid(net.ledger.get_block_by_number(net.ledger.height - 1))


def test_approval_recorded_under_creator_org_only(net):
    """The approval key embeds the creator's MSP id: Org1's admin cannot
    approve for Org2."""
    _approve(net, "Org1")
    assert net.pump_committed(1) == 1
    st = net.ledger.state
    assert st.get_state(LIFECYCLE_NS,
                        approval_key("newcc", 1, "Org1")) is not None
    assert st.get_state(LIFECYCLE_NS,
                        approval_key("newcc", 1, "Org2")) is None


def test_queryapproved_returns_my_orgs_digest(net):
    _approve(net, "Org1")
    assert net.pump_committed(1) == 1
    assert len(_query(net, [b"queryapproved", b"newcc", b"1"])) == 64
    assert _query(net, [b"queryapproved", b"newcc", b"2"]) == b""


def test_deploy_helper_runs_full_ceremony(net):
    """deploy_chaincode: a majority's approvals, then the commit; every
    lifecycle tx VALID."""
    assert net.deploy_chaincode("newcc", "1.0", 1) == 3
    for n in range(1, net.ledger.height):
        assert _all_valid(net.ledger.get_block_by_number(n))


def test_same_block_definition_does_not_affect_sibling_invokes(net):
    """A definition commit and an invoke of that chaincode in one block:
    the invoke validates under the committed (previous) definition; the
    next block under the new one."""
    pol = m.ApplicationPolicy(signature_policy=from_string(
        "OR('Org3.peer')")).encode()
    _approve(net, "Org1", name=b"mycc", version=b"9.9", policy=pol)
    _approve(net, "Org2", name=b"mycc", version=b"9.9", policy=pol)
    assert net.pump_committed(2) == 2
    sp, prop, _ = protoutil.create_chaincode_proposal(
        net.channel_id, LIFECYCLE_NS,
        [b"commit", b"mycc", b"9.9", b"1", pol], net.client)
    responses = [net.endorsers[o].process_proposal(sp)
                 for o in ("Org1", "Org2")]
    assert all(r.response.status == 200 for r in responses)
    def_env = protoutil.create_tx_from_responses(prop, responses, net.client)
    b = RWSetBuilder()
    b.add_write("mycc", "sameblock", b"v")
    peers = [net.peer_signers["Org1"], net.peer_signers["Org2"]]
    inv_env = protoutil.create_signed_tx(
        net.channel_id, "mycc", b.build().encode(), net.client, peers)

    def block_of(envs):
        tip = net.ledger.get_block_by_number(net.ledger.height - 1)
        return protoutil.new_block(
            net.ledger.height, protoutil.block_header_hash(tip.header), envs)
    blk = block_of([def_env, inv_env])
    flags = net.channel.validator().validate(blk)
    assert flags == [V.VALID, V.VALID], flags
    net.ledger.commit_block(blk, flags)
    inv2 = protoutil.create_signed_tx(
        net.channel_id, "mycc", b.build().encode(), net.client, peers)
    flags2 = net.channel.validator().validate(block_of([inv2]))
    assert flags2 == [V.ENDORSEMENT_POLICY_FAILURE], flags2


# --- the ceremony in both packages -----------------------------------------

def _ledger_record(ledger, pu):
    """Per block after genesis: (txflags, header hash)."""
    return [(list(pu.block_txflags(ledger.get_block_by_number(n))),
             pu.block_header_hash(ledger.get_block_by_number(n).header))
            for n in range(1, ledger.height)]


def test_ceremony_equals_reference(tmp_path, monkeypatch):
    """The reference's Network and the port's, built from the same
    material, run the ceremony for the same definition (policy Org1 AND
    Org3); each side's ordered blocks then go through the other side's
    validator and ledger too.  Txflags, block hashes and fingerprints are
    equal."""
    from fabric_mod_tpu.policy import from_string as j_from_string
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE"):
        monkeypatch.delenv(knob, raising=False)
    ref = JNetwork(str(tmp_path / "ref"), max_message_count=25,
                   batch_timeout="100ms")
    pnet = e2e.Network(str(tmp_path / "port"),
                       convert.network_material_from_reference(ref),
                       verifier=sw.SwVerifier(), tensor_policy=True)
    try:
        spec = "AND('Org1.peer', 'Org3.peer')"
        j_pol = jm.ApplicationPolicy(
            signature_policy=j_from_string(spec)).encode()
        p_pol = m.ApplicationPolicy(signature_policy=from_string(spec)).encode()
        assert j_pol == p_pol
        assert ref.deploy_chaincode("cc2", "1.0", 1, policy=j_pol) == 3
        assert pnet.deploy_chaincode("cc2", "1.0", 1, policy=p_pol) == 3
        # the other side's blocks validate to the same flags on each side
        for n in range(1, ref.ledger.height):
            raw = ref.ledger.get_block_by_number(n).encode()
            assert pnet.channel.validator().validate(m.Block.decode(raw)) \
                == list(jprotoutil.block_txflags(jm.Block.decode(raw)))
        for n in range(1, pnet.ledger.height):
            raw = pnet.ledger.get_block_by_number(n).encode()
            assert list(ref.channel.validator().validate(
                jm.Block.decode(raw))) == list(
                    protoutil.block_txflags(m.Block.decode(raw)))
        ref_rec = _ledger_record(ref.ledger, jprotoutil)
        port_rec = _ledger_record(pnet.ledger, protoutil)
        # the port commits each approval in its own block, the reference
        # both in one: the same txs, the same flags
        assert [f for fs, _h in ref_rec for f in fs] == \
            [f for fs, _h in port_rec for f in fs] == [V.VALID] * 3
        # equal definitions; equal state up to the approvals' tx ids
        assert ref.ledger.state.get_state("_lifecycle", "namespaces/cc2")[0] \
            == pnet.ledger.state.get_state(LIFECYCLE_NS,
                                           "namespaces/cc2")[0]
        # one chain through both: the port's blocks into a reference
        # ledger and the reference's into a port ledger give each side's
        # own fingerprint
        from fabric_mod_tpu.ledger.kvledger import KvLedger as JKvLedger
        from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
        jled = JKvLedger(str(tmp_path / "jled"), pnet.channel_id)
        pled = KvLedger(ref.channel_id, str(tmp_path / "pled"))
        try:
            for n in range(pnet.ledger.height):
                jled.commit_block(jm.Block.decode(
                    pnet.ledger.get_block_by_number(n).encode()))
            for n in range(ref.ledger.height):
                pled.commit_block(m.Block.decode(
                    ref.ledger.get_block_by_number(n).encode()))
            assert jled.state_fingerprint() == \
                pnet.ledger.state_fingerprint()
            assert pled.state_fingerprint() == ref.ledger.state_fingerprint()
            assert [h for _f, h in _ledger_record(jled, jprotoutil)] == \
                [h for _f, h in port_rec]
            assert [h for _f, h in _ledger_record(pled, protoutil)] == \
                [h for _f, h in ref_rec]
        finally:
            jled.close()
            pled.close()
    finally:
        pnet.close()
        ref.close()
