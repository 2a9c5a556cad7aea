"""The port's idemix layer (fabric_mod_tpu_torch/idemix/, msp/idemixmsp.py)
against the JAX package's, with state carried across as plain data
through fabric_mod_tpu_torch/convert.py: issuer keys and credentials as
their to_dict() dicts, presentations as the idemix MSP's JSON signature
bytes, revocation lists as CRI dicts.

Presentations signed in one package verify in the other, with the three
planted kinds (Ā tampered by + G, a wrong disclosed value, A′ =
identity): in the port on the device path (its batched pairing, on the
CPU here) and on the host path, in the reference on its host path.  The
port's world is made from a seed; the reference's signer draws its own
randomness, which changes no verdict."""
import json

import pytest
import torch

from fabric_mod_tpu.idemix import credential as Jcred
from fabric_mod_tpu.idemix import fp256bn as Jbn
from fabric_mod_tpu.idemix import revocation as Jrev
from fabric_mod_tpu.msp import idemixmsp as Jmsp
from fabric_mod_tpu.protos import messages as Jm
from fabric_mod_tpu_torch import convert
from fabric_mod_tpu_torch.idemix import credential as Tcred
from fabric_mod_tpu_torch.idemix import revocation as Trev
from fabric_mod_tpu_torch.msp import idemixmsp as Tmsp
from fabric_mod_tpu_torch.protos import messages as Tm
from fabric_mod_tpu_torch.utils import fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    return fixtures.make_idemix_world(seed=7)


@pytest.fixture(scope="module")
def ref_ik(world):
    """The port issuer's key (secret included) as a reference IssuerKey."""
    return Jcred.IssuerKey.from_dict(world.issuer.key.to_dict())


def test_issuer_key_round_trips(world, ref_ik):
    ik = world.issuer.key
    back = convert.issuer_key_from_reference(ref_ik.to_dict())
    for k in (ik, back):
        assert (k.W.x.a, k.W.y.b, k.x, k.pok_c, k.pok_z) == \
            (ref_ik.W.x.a, ref_ik.W.y.b, ref_ik.x, ref_ik.pok_c, ref_ik.pok_z)
        assert (k.HSk.x, k.HRand.y) == (ref_ik.HSk.x, ref_ik.HRand.y)
    assert Tcred.IssuerKey.from_dict(ik.to_dict()).to_dict() == ik.to_dict()
    public = convert.issuer_key_from_reference(ref_ik.public_dict())
    assert public.x is None and public.check_pok()
    with pytest.raises(Tcred.IdemixError):
        Tcred.issue(public, 1, [1, 2, 3, 4])
    with pytest.raises(TypeError):
        convert.issuer_key_from_reference(ref_ik)        # no object crosses
    # same seed, same world
    again = fixtures.make_idemix_world(seed=7)
    assert again.issuer.key.to_dict() == ik.to_dict()
    assert again.users[1]._cred.to_dict() == world.users[1]._cred.to_dict()


def _ref_presentations(world, ref_ik):
    """4 reference-signed presentations by the port world's user 1: one
    valid and the three planted kinds, as JSON bytes."""
    user = world.users[1]
    cred = Jcred.Credential.from_dict(user._cred.to_dict())
    assert Jcred.credential_valid(ref_ik, cred)
    out, expect = [], [True, False, False, False]
    for i in range(4):
        msg = b"ref-tx-%d" % i
        disclosed = user._disclosed()
        sig = Jcred.sign(ref_ik, cred, user._sk, msg, disclosed)
        if i == 1:
            sig.A_bar = Jbn.g1_add(sig.A_bar, Jbn.G1.generator())
        elif i == 2:
            disclosed = dict(disclosed)
            disclosed[Tmsp.ATTR_ROLE] += 1
        elif i == 3:
            sig.A_prime = None
        raw = json.dumps(Jmsp._sig_to_dict(sig), sort_keys=True).encode()
        out.append((raw, msg, disclosed))
    return out, expect


def test_reference_presentations_verify_in_port(world, ref_ik):
    raw, expect = _ref_presentations(world, ref_ik)
    items = [(convert.presentation_from_reference(r), msg, d)
             for r, msg, d in raw]
    ik = world.issuer.key
    assert Tcred.batch_verify(ik, items, device="cpu") == expect
    assert Tcred.batch_verify(ik, items, use_device=False) == expect


def test_port_presentations_verify_in_reference(world, ref_ik):
    items, expect = fixtures.make_presentations(world, 6, plant_every=2)
    keep = [0, 1, 3, 5]                  # one valid, the three kinds
    items = [items[i] for i in keep]
    expect = [expect[i] for i in keep]
    assert expect == [True, False, False, False]
    ref_items = [(Jmsp._sig_from_dict(json.loads(
        convert.presentation_to_reference(sig))), msg, d)
        for sig, msg, d in items]
    assert Jcred.batch_verify(ref_ik, ref_items, use_device=False) == expect
    assert Tcred.batch_verify(world.issuer.key, items, device="cpu") == expect


def test_batch_verify_needs_a_card_unless_told(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None resolves to it")
    items, _ = fixtures.make_presentations(world, 1)
    with pytest.raises(RuntimeError):
        Tcred.batch_verify(world.issuer.key, items)


def test_reference_cri_verifies_in_port(world):
    ref_ra = Jrev.RevocationAuthority()
    ref_ra.revoke(world.users[2].revocation_handle)
    cri = convert.cri_from_reference(ref_ra.cri().to_dict())
    assert Trev.verify_cri(cri, ref_ra.public_pem)
    assert Trev.verify_cri(cri, ref_ra.public_pem, expected_epoch=1)
    assert not Trev.verify_cri(cri, ref_ra.public_pem, expected_epoch=2)
    assert not Trev.verify_cri(cri, world.ra.public_pem)
    forged = Trev.CRI.from_dict(cri.to_dict())
    forged.epoch += 1
    assert not Trev.verify_cri(forged, ref_ra.public_pem)
    assert cri.is_revoked(world.users[2].revocation_handle)
    # and back: the port RA's list verifies in the reference
    port_cri = world.ra.cri()
    assert Jrev.verify_cri(Jrev.CRI.from_dict(port_cri.to_dict()),
                           world.ra.public_pem)
    # a port MSP configured with the reference RA's key adopts its list
    msp = Tmsp.IdemixMsp(fixtures.IDEMIX_MSPID, world.issuer.key,
                         revocation_pk_pem=ref_ra.public_pem)
    msp.set_cri(cri)


def test_revoked_handles_fail_and_epochs_never_regress():
    world = fixtures.make_idemix_world(seed=8, n_users=2)
    issuer, ra, msp = world.issuer, world.ra, world.msp
    alice, bob = world.users
    old = ra.cri()
    msp.set_cri(old)
    signers = [Tmsp.IdemixSigningIdentity(u, issuer.key, disclose_rh=True)
               for u in (alice, bob)]
    idents = [msp.deserialize_identity(s.serialize()) for s in signers]
    assert all(i.verify(b"m", s.sign_message(b"m"))
               for i, s in zip(idents, signers))
    ra.revoke(alice.revocation_handle)
    msp.set_cri(ra.cri())
    assert not idents[0].verify(b"m", signers[0].sign_message(b"m"))
    assert idents[1].verify(b"m", signers[1].sign_message(b"m"))
    # hiding the handle under an enforcing MSP is refused
    hiding = Tmsp.IdemixSigningIdentity(bob, issuer.key)
    assert not idents[1].verify(b"m", hiding.sign_message(b"m"))
    with pytest.raises(Tmsp.IdemixError):
        msp.set_cri(old)                       # epoch regression
    # the reference MSP takes the port RA's list and agrees
    ref_msp = Jmsp.IdemixMsp(fixtures.IDEMIX_MSPID,
                             Jcred.IssuerKey.from_dict(issuer.key.to_dict()),
                             revocation_pk_pem=ra.public_pem)
    ref_msp.set_cri(Jrev.CRI.from_dict(ra.cri().to_dict()))
    ref_ident = ref_msp.deserialize_identity(signers[0].serialize())
    assert not ref_ident.verify(b"m", signers[0].sign_message(b"m"))
    with pytest.raises(Jmsp.IdemixError):
        ref_msp.set_cri(Jrev.CRI.from_dict(old.to_dict()))


def _principals():
    out = []
    for mspid in (fixtures.IDEMIX_MSPID, "OtherOrg"):
        for role in (Tm.MSPRoleType.MEMBER, Tm.MSPRoleType.ADMIN,
                     Tm.MSPRoleType.CLIENT, Tm.MSPRoleType.PEER,
                     Tm.MSPRoleType.ORDERER):
            out.append(Tm.MSPPrincipal(
                principal_classification=Tm.PrincipalClassification.ROLE,
                principal=Tm.MSPRole(msp_identifier=mspid,
                                     role=role).encode()).encode())
        for ou in ("client", "peer", "admin"):
            out.append(Tm.MSPPrincipal(
                principal_classification=Tm.PrincipalClassification
                .ORGANIZATION_UNIT,
                principal=Tm.OrganizationUnit(
                    msp_identifier=mspid,
                    organizational_unit_identifier=ou).encode()).encode())
    out.append(Tm.MSPPrincipal(
        principal_classification=Tm.PrincipalClassification.IDENTITY,
        principal=b"whatever").encode())
    return out


def test_satisfies_principal_matches_reference(world, ref_ik):
    ref_msp = Jmsp.IdemixMsp(fixtures.IDEMIX_MSPID, ref_ik)
    got, want = [], []
    for ou in ("client", "peer"):
        for role in (Tmsp.ROLE_MEMBER, Tmsp.ROLE_ADMIN):
            raw = Tm.SerializedIdentity(
                mspid=fixtures.IDEMIX_MSPID,
                id_bytes=json.dumps({"ou": ou, "role": role},
                                    sort_keys=True).encode()).encode()
            ti = world.msp.deserialize_identity(raw)
            ji = ref_msp.deserialize_identity(raw)
            world.msp.validate(ti)
            for p in _principals():
                got.append(world.msp.satisfies_principal(
                    ti, Tm.MSPPrincipal.decode(p)))
                want.append(ref_msp.satisfies_principal(
                    ji, Jm.MSPPrincipal.decode(p)))
    assert got == want
    assert any(got) and not all(got)
    with pytest.raises(Tmsp.IdemixError):
        world.msp.deserialize_identity(Tm.SerializedIdentity(
            mspid="OtherOrg", id_bytes=b"{}").encode())
