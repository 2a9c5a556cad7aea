"""Idemix MSP: anonymous, unlinkable membership.

The port's copy of fabric_mod_tpu/msp/idemixmsp.py over the port's
idemix/ and protos/.  `IdemixIssuer` takes an optional `rng` (a
random.Random) for its key and the users it issues, so a fixture builds
the same membership on any machine.

(reference: msp/idemixmsp.go — the MSP implementation over idemix
credentials: DeserializeIdentity decodes a presentation, Validate
checks the credential proof, Verify checks a message signature bound
to the presentation's pseudonym — and bccsp/idemix's signer bridge.)

Identities here are PRESENTATIONS: each serialized identity carries a
fresh BBS+ presentation proof disclosing only the OU + role
attributes, so two transactions by the same user are unlinkable.
Message signing uses the presentation's Fiat-Shamir binding: the
signature is a fresh presentation over the message bytes (the
reference binds a pseudonym key; the spike binds the proof itself —
same unlinkability property, simpler state).

Attribute layout (reference: idemix attributes ou/role/enrollment/
revocation-handle): [0]=OU, [1]=role, [2]=enrollment id, [3]=rh;
presentations disclose {0, 1} only.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional

from fabric_mod_tpu_torch.idemix import credential as idmx
from fabric_mod_tpu_torch.idemix.fp256bn import G1
from fabric_mod_tpu_torch.idemix.revocation import verify_cri
from fabric_mod_tpu_torch.protos import messages as m

ATTR_OU, ATTR_ROLE, ATTR_EID, ATTR_RH = 0, 1, 2, 3
ROLE_MEMBER, ROLE_ADMIN = 1, 2


class IdemixError(Exception):
    pass


def _attr_int(value: str) -> int:
    return int.from_bytes(
        hashlib.sha256(value.encode()).digest(), "big") % idmx.R


class IdemixIssuer:
    """Issuer-side: setup + credential issuance (reference:
    idemixgen's issuer role + msp config generation)."""

    def __init__(self, mspid: str, rng=None):
        self.mspid = mspid
        self._rng = rng
        self.key = idmx.IssuerKey(["ou", "role", "enrollment", "rh"], rng=rng)

    def issue_user(self, enrollment_id: str, ou: str = "client",
                   role: int = ROLE_MEMBER) -> "IdemixUser":
        sk = idmx._rand_zr(self._rng)
        attrs = [_attr_int(ou), role, _attr_int(enrollment_id),
                 idmx._rand_zr(self._rng)]
        cred = idmx.issue(self.key, sk, attrs, rng=self._rng)
        return IdemixUser(self.mspid, sk, cred, ou, role)


class IdemixUser:
    """Holder-side: creates unlinkable signing identities."""

    def __init__(self, mspid: str, sk: int, cred: idmx.Credential,
                 ou: str, role: int):
        self.mspid = mspid
        self._sk = sk
        self._cred = cred
        self.ou = ou
        self.role = role

    @property
    def revocation_handle(self) -> int:
        return self._cred.attrs[ATTR_RH]

    def _disclosed(self, disclose_rh: bool = False) -> Dict[int, int]:
        out = {ATTR_OU: _attr_int(self.ou), ATTR_ROLE: self.role}
        if disclose_rh:
            # revocation-enforcing verifiers need the handle bound
            # into the proof (see idemix/revocation.py's privacy note)
            out[ATTR_RH] = self.revocation_handle
        return out


class IdemixSigningIdentity:
    """One unlinkable identity: a presentation bound to this session.

    sign_message(msg) creates a fresh proof over msg with the same
    disclosed attributes; verifiers check it against the issuer public
    key carried by the MSP."""

    def __init__(self, user: IdemixUser, issuer_key: idmx.IssuerKey,
                 disclose_rh: bool = False):
        self.mspid = user.mspid
        self._user = user
        self._ik = issuer_key
        self._disclose_rh = disclose_rh

    def serialize(self) -> bytes:
        payload = json.dumps({
            "ou": self._user.ou, "role": self._user.role},
            sort_keys=True).encode()
        return m.SerializedIdentity(mspid=self.mspid,
                                    id_bytes=payload).encode()

    def sign_message(self, msg: bytes) -> bytes:
        disclosed = self._user._disclosed(self._disclose_rh)
        sig = idmx.sign(self._ik, self._user._cred, self._user._sk,
                        msg, disclosed)
        d = _sig_to_dict(sig)
        if self._disclose_rh:
            d["rh"] = str(self._user.revocation_handle)
        return json.dumps(d, sort_keys=True).encode()


def _sig_to_dict(sig: idmx.Signature) -> dict:
    # JSON-safe encoding (hex for group elements/nonce, decimal
    # strings for Zr scalars).  NEVER pickle here: these bytes arrive
    # from untrusted remote clients.
    def g1(p):
        return idmx._g1_bytes(p).hex()
    return {
        "A_prime": g1(sig.A_prime), "A_bar": g1(sig.A_bar),
        "B_prime": g1(sig.B_prime), "c": str(sig.c),
        "z_e": str(sig.z_e), "z_r2": str(sig.z_r2),
        "z_r3": str(sig.z_r3), "z_s": str(sig.z_s),
        "z_sk": str(sig.z_sk),
        "z_attrs": {str(k): str(v) for k, v in sig.z_attrs.items()},
        "nonce": sig.nonce.hex(),
    }


def _sig_from_dict(d: dict) -> idmx.Signature:
    def g1(hexs: str) -> Optional[G1]:
        b = bytes.fromhex(hexs)
        if b == b"\x00" * 64:
            return None
        return G1(int.from_bytes(b[:32], "big"),
                  int.from_bytes(b[32:], "big"))
    return idmx.Signature(
        A_prime=g1(d["A_prime"]), A_bar=g1(d["A_bar"]),
        B_prime=g1(d["B_prime"]), c=int(d["c"]), z_e=int(d["z_e"]),
        z_r2=int(d["z_r2"]), z_r3=int(d["z_r3"]), z_s=int(d["z_s"]),
        z_sk=int(d["z_sk"]),
        z_attrs={int(k): int(v) for k, v in d["z_attrs"].items()},
        nonce=bytes.fromhex(d["nonce"]))


class IdemixIdentity:
    """Verifier-side view of a deserialized idemix identity."""

    def __init__(self, mspid: str, ou: str, role: int,
                 issuer_key: idmx.IssuerKey, cri_fn=None):
        self.mspid = mspid
        self.ou = ou
        self.role = role
        self._ik = issuer_key
        self._cri_fn = cri_fn              # () -> CRI | None

    def serialize(self) -> bytes:
        payload = json.dumps({"ou": self.ou, "role": self.role},
                             sort_keys=True).encode()
        return m.SerializedIdentity(mspid=self.mspid,
                                    id_bytes=payload).encode()

    def verify(self, msg: bytes, sig_bytes: bytes) -> bool:
        try:
            d = json.loads(sig_bytes)
            sig = _sig_from_dict(d)
        except Exception:
            return False
        disclosed = {ATTR_OU: _attr_int(self.ou),
                     ATTR_ROLE: self.role}
        cri = self._cri_fn() if self._cri_fn is not None else None
        if cri is not None:
            # revocation enforced: the presentation must disclose its
            # handle (binding it into the credential via the ordinary
            # disclosed-attribute relation) and the handle must not be
            # in the CRI (reference: signature.go:243 Ver's
            # non-revocation check).  The field is attacker
            # controlled: any malformed/out-of-range value is a
            # verification failure, never an exception (one crafted
            # signature must not abort block validation).
            try:
                rh = int(d["rh"])
                if not 0 <= rh < (1 << 256):
                    return False
            except (KeyError, ValueError, TypeError):
                return False
            if cri.is_revoked(rh):
                return False
            disclosed[ATTR_RH] = rh
        return idmx.verify(self._ik, sig, msg, disclosed)

    def verify_item(self, msg: bytes, sig: bytes):
        """No block-path batch item, as in the reference: idemix creators
        in a block keep the host verdict (`verify`)."""
        return None


class IdemixMsp:
    """(reference: msp/idemixmsp.go)"""

    def __init__(self, mspid: str, issuer_key: idmx.IssuerKey,
                 revocation_pk_pem: Optional[bytes] = None):
        self.mspid = mspid
        self._ik = issuer_key
        self._revocation_pk = revocation_pk_pem
        self._cri = None
        if not issuer_key.check_pok():
            raise IdemixError("issuer key proof of knowledge fails")

    def set_cri(self, cri, expected_epoch: Optional[int] = None) -> None:
        """Adopt a CRI after verifying the RA signature + epoch pin
        (reference: the CRI refresh of idemixmsp Setup/Validate).
        Requires the MSP to have been configured with the RA public
        key; a CRI that fails verification is refused."""
        if self._revocation_pk is None:
            raise IdemixError("this MSP has no revocation authority "
                              "public key configured")
        if not verify_cri(cri, self._revocation_pk, expected_epoch):
            raise IdemixError("CRI verification failed")
        if self._cri is not None and cri.epoch < self._cri.epoch:
            raise IdemixError("CRI epoch regression")
        self._cri = cri

    def deserialize_identity(self, serialized: bytes) -> IdemixIdentity:
        sid = m.SerializedIdentity.decode(serialized)
        if sid.mspid != self.mspid:
            raise IdemixError(f"identity for {sid.mspid!r}, "
                              f"not {self.mspid!r}")
        try:
            d = json.loads(sid.id_bytes)
            ou, role = str(d["ou"]), int(d["role"])
        except Exception as e:
            raise IdemixError(f"bad idemix identity: {e}") from e
        return IdemixIdentity(self.mspid, ou, role, self._ik,
                              cri_fn=lambda: self._cri)

    def validate(self, ident: IdemixIdentity) -> None:
        if ident.mspid != self.mspid:
            raise IdemixError("wrong msp")

    def satisfies_principal(self, ident: IdemixIdentity,
                            principal: m.MSPPrincipal) -> bool:
        """(reference: idemixmsp.go SatisfiesPrincipal — role and OU
        principals over the DISCLOSED attributes)"""
        if principal.principal_classification == \
                m.PrincipalClassification.ROLE:
            role = m.MSPRole.decode(principal.principal)
            if role.msp_identifier != self.mspid:
                return False
            if role.role == m.MSPRoleType.MEMBER:
                return True
            if role.role == m.MSPRoleType.ADMIN:
                return ident.role == ROLE_ADMIN
            if role.role == m.MSPRoleType.CLIENT:
                return ident.ou == "client"
            if role.role == m.MSPRoleType.PEER:
                return ident.ou == "peer"
            return False
        if principal.principal_classification == \
                m.PrincipalClassification.ORGANIZATION_UNIT:
            ou = m.OrganizationUnit.decode(principal.principal)
            return (ou.msp_identifier == self.mspid and
                    ou.organizational_unit_identifier == ident.ou)
        return False
