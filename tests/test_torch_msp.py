"""The port's MSP (its own X.509 layer, no `cryptography`) against the
JAX reference's (over `cryptography`), in both directions: certificates
issued by the reference's CA read by the port, and certificates issued
by the port's seeded CA read by the reference.  The same identities go
through deserialize / validate / satisfies_principal over a principal
matrix with a wrong org, wrong roles, an untrusted CA, an expired
certificate and an unknown MSP; every outcome must agree."""
import datetime

import pytest

from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.msp import ca as jca
from fabric_mod_tpu.msp import identities as jid
from fabric_mod_tpu.msp.mspimpl import Msp as JMsp
from fabric_mod_tpu.msp.mspimpl import MspManager as JMspManager
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.msp import ca as pca
from fabric_mod_tpu_torch.msp import identities as pid
from fabric_mod_tpu_torch.msp.cache import CachedMsp
from fabric_mod_tpu_torch.msp.mspimpl import Msp, MspManager
from fabric_mod_tpu_torch.protos import messages as m

ORGS = ("Org1", "Org2", "Org3")


def _issue_world(cert_pem, make_ca):
    """CA certificate PEMs of three orgs and a list of (label, mspid,
    cert PEM) identities, issued by one package."""
    cas = {org: make_ca(f"ca.{org.lower()}", org, False) for org in ORGS}
    rogue = make_ca("ca.org1", "Org1", True)    # same subject, other key
    past = datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc)
    idents = []
    for label, ca, cn, org, ous, kw in (
            ("org1-peer", cas["Org1"], "peer0.org1", "Org1", ["peer"], {}),
            ("org2-peer", cas["Org2"], "peer0.org2", "Org2", ["peer"], {}),
            ("org1-client", cas["Org1"], "client@org1", "Org1", ["client"], {}),
            ("org1-admin", cas["Org1"], "admin@org1", "Org1", ["admin"], {}),
            ("org1-ca-leaf", cas["Org1"], "subca.org1", "Org1", [],
             {"is_ca": True}),
            ("org1-expired", cas["Org1"], "old.org1", "Org1", ["peer"],
             {"not_after": past}),
            ("untrusted", rogue, "peer9.org1", "Org1", ["peer"], {})):
        cert, _key = ca.issue(cn, org, ous=ous, **kw)
        idents.append((label, org, cert_pem(cert)))
    idents.append(("unknown-msp", "Org4", idents[0][2]))
    return {org: ca.cert_pem() for org, ca in cas.items()}, idents


def _principals(mod, org1_peer_serialized):
    role = mod.MSPRoleType
    out = []
    for org in ("Org1", "Org2", "Org3"):
        for r in (role.MEMBER, role.ADMIN, role.CLIENT, role.PEER,
                  role.ORDERER):
            out.append(mod.MSPPrincipal(
                principal_classification=mod.PrincipalClassification.ROLE,
                principal=mod.MSPRole(msp_identifier=org, role=r).encode()))
    out.append(mod.MSPPrincipal(
        principal_classification=mod.PrincipalClassification.IDENTITY,
        principal=org1_peer_serialized))
    for org, ou in (("Org1", "client"), ("Org1", "peer"), ("Org2", "client")):
        out.append(mod.MSPPrincipal(
            principal_classification=(
                mod.PrincipalClassification.ORGANIZATION_UNIT),
            principal=mod.OrganizationUnit(
                msp_identifier=org,
                organizational_unit_identifier=ou).encode()))
    return out


def _outcomes(mgr, mod, idents, principals):
    """(label, deserialized?, valid?, [satisfies per principal],
    serialize() bytes) for every identity."""
    out = []
    for label, mspid, pem in idents:
        raw = mod.SerializedIdentity(mspid=mspid, id_bytes=pem).encode()
        try:
            ident = mgr.deserialize_identity(raw)
        except Exception:
            out.append((label, False, False, [], b""))
            continue
        try:
            mgr.validate(ident)
            valid = True
        except Exception:
            valid = False
        out.append((label, True, valid,
                    [bool(mgr.satisfies_principal(ident, p))
                     for p in principals], ident.serialize()))
    return out


def _port_mgr(ca_pems, cached):
    from fabric_mod_tpu_torch.bccsp import x509
    csp = sw.SwCSP()
    mgr = MspManager([Msp(org, csp, [x509.load_pem_x509_certificate(p)])
                      for org, p in ca_pems.items()])
    return CachedMsp(mgr) if cached else mgr


def _reference_mgr(ca_pems):
    csp = JSwCSP()
    return JMspManager([JMsp(org, csp, [jid.deserialize_cert(p)])
                        for org, p in ca_pems.items()])


def _reference_issued():
    return _issue_world(jca.cert_pem,
                        lambda name, org, _rogue: jca.CA(name, org))


def _port_issued():
    return _issue_world(pca.cert_pem,
                        lambda name, org, rogue: pca.CA(
                            name, org, seed=b"rogue" if rogue else b"msp"))


@pytest.mark.parametrize("issuer", ["reference", "port"])
@pytest.mark.parametrize("cached", [False, True])
def test_principal_matrix_agrees(issuer, cached):
    ca_pems, idents = (_reference_issued if issuer == "reference"
                       else _port_issued)()
    org1_peer = m.SerializedIdentity(mspid="Org1",
                                     id_bytes=idents[0][2]).encode()
    got = _outcomes(_port_mgr(ca_pems, cached), m, idents,
                    _principals(m, org1_peer))
    want = _outcomes(_reference_mgr(ca_pems), jm, idents,
                     _principals(jm, org1_peer))
    assert got == want
    by_label = {row[0]: row for row in got}
    # the matrix is not vacuous: valid and invalid identities, and
    # principals both satisfied and not
    assert by_label["org1-peer"][2] and by_label["org1-client"][2]
    for bad in ("org1-ca-leaf", "org1-expired", "untrusted"):
        assert by_label[bad][1] and not by_label[bad][2]
    assert not by_label["unknown-msp"][1]
    assert any(by_label["org1-peer"][3]) and not all(by_label["org1-peer"][3])


@pytest.mark.parametrize("issuer", ["reference", "port"])
def test_certificate_fields_agree(issuer):
    """Fingerprint over the original DER, serial, validity window, OUs,
    common name and the subject key, read by both packages from the
    same PEM; and the PEM re-encoding is byte-identical."""
    ca_pems, idents = (_reference_issued if issuer == "reference"
                       else _port_issued)()
    for pem in [*ca_pems.values(), *(p for _l, _o, p in idents)]:
        c = pid.deserialize_cert(pem)
        jc = jid.deserialize_cert(pem)
        assert pid.cert_fingerprint(c) == jid.cert_fingerprint(jc)
        assert c.serial_number == jc.serial_number
        assert c.not_valid_before_utc == jc.not_valid_before_utc
        assert c.not_valid_after_utc == jc.not_valid_after_utc
        assert c.subject.public_bytes() == jc.subject.public_bytes()
        assert c.issuer.public_bytes() == jc.issuer.public_bytes()
        assert c.pem() == jc.public_bytes(jid.serialization.Encoding.PEM)
        for oid in ("COMMON_NAME", "ORGANIZATION_NAME",
                    "ORGANIZATIONAL_UNIT_NAME"):
            assert [a.value for a in c.subject.get_attributes_for_oid(
                getattr(pid.x509.NameOID, oid))] == \
                [a.value for a in jc.subject.get_attributes_for_oid(
                    getattr(jid.x509.NameOID, oid))]
        jx = jc.public_key().public_numbers()
        assert (c.public_key().x, c.public_key().y) == (jx.x, jx.y)


def test_seeded_ca_is_reproducible_and_signers_cross_verify():
    """One seed, one `now`: the same certificates byte for byte; a port
    signer's message signature verifies under the reference identity of
    the same certificate, and a reference signer's under the port's."""
    now = datetime.datetime(2025, 6, 1, tzinfo=datetime.timezone.utc)
    a = pca.CA("ca.org1", "Org1", seed=b"s", now=now)
    b = pca.CA("ca.org1", "Org1", seed=b"s", now=now)
    ca_, cb = a.issue("peer0.org1", "Org1", ous=["peer"])[0], \
        b.issue("peer0.org1", "Org1", ous=["peer"])[0]
    assert a.cert_pem() == b.cert_pem() and ca_.pem() == cb.pem()

    cert, key = a.issue("client@org1", "Org1", ous=["client"])
    port_signer = pid.SigningIdentity("Org1", cert, pca.key_pem(key),
                                      sw.SwCSP())
    ref_ident = jid.Identity("Org1", jid.deserialize_cert(cert.pem()),
                             JSwCSP())
    sig = port_signer.sign_message(b"hello")
    assert ref_ident.verify(b"hello", sig)

    jca_ = jca.CA("ca.org2", "Org2")
    jcert, jkey = jca_.issue("client@org2", "Org2", ous=["client"])
    ref_signer = jid.SigningIdentity("Org2", jcert, jca.key_pem(jkey),
                                     JSwCSP())
    port_ident = pid.Identity("Org2", pid.deserialize_cert(jca.cert_pem(jcert)),
                              sw.SwCSP())
    sig = ref_signer.sign_message(b"world")
    assert port_ident.verify(b"world", sig)
    assert not port_ident.verify(b"worle", sig)
    item = port_ident.verify_item(b"world", sig)
    assert sw.verify_item(item)
