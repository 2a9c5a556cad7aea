"""The X.509 MSP: deserialize, validate, classify, match principals.

The port's copy of fabric_mod_tpu/msp/mspimpl.py (reference:
msp/mspimpl.go, msp/mspimplvalidate.go, msp/mspimplsetup.go) over the
port's own X.509 layer (bccsp/x509.py).  Validation builds the issuer
chain by subject lookup against the MSP's root/intermediate CAs and
checks each link's signature, validity window, CA flag, and revocation
by serial; roles come from NodeOUs with an explicit admin-cert list as
fallback.  Certificate revocation lists are not carried by the port.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence

from fabric_mod_tpu_torch.bccsp import x509
from fabric_mod_tpu_torch.msp.identities import (
    Identity, SigningIdentity, cert_fingerprint, deserialize_cert)
from fabric_mod_tpu_torch.protos import messages as m


class MSPValidationError(Exception):
    pass


def _check_link(child: x509.Certificate, issuer: x509.Certificate) -> bool:
    """Does `issuer` sign `child`?"""
    return issuer.public_key().verify_signature(
        child.signature, child.tbs_certificate_bytes)


def _is_ca_cert(cert: x509.Certificate) -> bool:
    try:
        bc = cert.extensions.get_extension_for_class(
            x509.BasicConstraints).value
        return bool(bc.ca)
    except x509.ExtensionNotFound:
        return False
    except ValueError as e:              # duplicate extensions
        raise MSPValidationError(f"malformed certificate extensions: {e}")


class NodeOUs:
    """OU-based role classification config (reference:
    msp/configbuilder.go NodeOUs)."""

    def __init__(self, enable: bool = True, client_ou: str = "client",
                 peer_ou: str = "peer", admin_ou: str = "admin",
                 orderer_ou: str = "orderer"):
        self.enable = enable
        self.client_ou, self.peer_ou = client_ou, peer_ou
        self.admin_ou, self.orderer_ou = admin_ou, orderer_ou


class Msp:
    """One organisation's MSP.  `raw_messages` makes its identities'
    verify items carry raw messages (hashed on the card)."""

    def __init__(self, mspid: str, csp,
                 root_certs: Sequence[x509.Certificate],
                 intermediate_certs: Sequence[x509.Certificate] = (),
                 admin_certs: Sequence[x509.Certificate] = (),
                 revoked_serials: Sequence[int] = (),
                 node_ous: Optional[NodeOUs] = None,
                 raw_messages: bool = False):
        self.mspid = mspid
        self._csp = csp
        self.raw_messages = raw_messages
        self.roots = list(root_certs)
        self.intermediates = list(intermediate_certs)
        self._by_subject: Dict[bytes, List[x509.Certificate]] = {}
        for c in [*self.roots, *self.intermediates]:
            self._by_subject.setdefault(
                c.subject.public_bytes(), []).append(c)
        self._root_fps = {cert_fingerprint(c) for c in self.roots}
        self._admin_fps = {cert_fingerprint(c) for c in admin_certs}
        self._revoked = set(revoked_serials)
        self.node_ous = node_ous or NodeOUs()

    # -- identity lifecycle --
    def deserialize_identity(self, serialized: bytes) -> Identity:
        sid = m.SerializedIdentity.decode(serialized)
        if sid.mspid != self.mspid:
            raise MSPValidationError(
                f"identity MSP {sid.mspid!r} != {self.mspid!r}")
        cert = deserialize_cert(sid.id_bytes)
        return Identity(self.mspid, cert, self._csp, self.raw_messages)

    def validate(self, ident: Identity) -> None:
        """Raise MSPValidationError unless the identity chains to our
        roots and is unexpired/unrevoked.  A CA certificate is not an
        identity (reference: msp/mspimpl.go:713-716, chain length >= 2
        at :747-749)."""
        if _is_ca_cert(ident.cert):
            raise MSPValidationError(
                "a CA certificate cannot be used as an identity")
        chain = self._chain_for(ident.cert)
        if len(chain) < 2:
            raise MSPValidationError(
                "identity chain must include at least one CA above the leaf")
        now = datetime.datetime.now(datetime.timezone.utc)
        for cert in chain:
            if now < cert.not_valid_before_utc or now > cert.not_valid_after_utc:
                raise MSPValidationError(
                    f"certificate {cert.subject.rfc4514_string()!r} outside"
                    " validity window")
            # revocation applies to the whole chain
            if cert.serial_number in self._revoked:
                raise MSPValidationError("certificate revoked")
        self._check_key_usage(ident.cert)

    @staticmethod
    def _check_key_usage(cert: x509.Certificate) -> None:
        """Leaves carrying a KeyUsage extension must allow
        digitalSignature — identities exist to sign."""
        try:
            ku = cert.extensions.get_extension_for_class(x509.KeyUsage).value
        except x509.ExtensionNotFound:
            return
        except ValueError as e:          # duplicate extensions
            raise MSPValidationError(
                f"malformed certificate extensions: {e}")
        if not ku.digital_signature:
            raise MSPValidationError(
                "leaf KeyUsage does not permit digitalSignature")

    def is_valid(self, ident: Identity) -> bool:
        try:
            self.validate(ident)
            return True
        except MSPValidationError:
            return False

    def _chain_for(self, cert: x509.Certificate) -> List[x509.Certificate]:
        """leaf -> ... -> root.  Raises if no path to a root exists."""
        chain = [cert]
        cur = cert
        for _ in range(10):                        # depth bound
            if cert_fingerprint(cur) in self._root_fps:
                return chain
            candidates = self._by_subject.get(
                cur.issuer.public_bytes(), [])
            issuer = next((c for c in candidates if _check_link(cur, c)), None)
            if issuer is None:
                raise MSPValidationError(
                    f"no trusted issuer for {cur.subject.rfc4514_string()!r}")
            try:
                bc = issuer.extensions.get_extension_for_class(
                    x509.BasicConstraints).value
                if not bc.ca:
                    raise MSPValidationError("issuer is not a CA")
            except x509.ExtensionNotFound:
                raise MSPValidationError("issuer lacks BasicConstraints")
            chain.append(issuer)
            cur = issuer
        raise MSPValidationError("chain too deep")

    # -- roles / principals --
    def _has_ou(self, ident: Identity, ou: str) -> bool:
        return ou in ident.organizational_units()

    def is_admin(self, ident: Identity) -> bool:
        if cert_fingerprint(ident.cert) in self._admin_fps:
            return True
        return self.node_ous.enable and self._has_ou(
            ident, self.node_ous.admin_ou)

    def satisfies_principal(self, ident: Identity,
                            principal: m.MSPPrincipal) -> bool:
        """(reference: msp/mspimpl.go SatisfiesPrincipal)"""
        cls = principal.principal_classification
        if cls == m.PrincipalClassification.ROLE:
            role = m.MSPRole.decode(principal.principal)
            if role.msp_identifier != self.mspid:
                return False
            if not self.is_valid(ident):
                return False
            r = role.role
            if r == m.MSPRoleType.MEMBER:
                return True
            if r == m.MSPRoleType.ADMIN:
                return self.is_admin(ident)
            if r == m.MSPRoleType.CLIENT:
                return self._has_ou(ident, self.node_ous.client_ou)
            if r == m.MSPRoleType.PEER:
                return self._has_ou(ident, self.node_ous.peer_ou)
            if r == m.MSPRoleType.ORDERER:
                return self._has_ou(ident, self.node_ous.orderer_ou)
            return False
        if cls == m.PrincipalClassification.IDENTITY:
            return principal.principal == ident.serialize()
        if cls == m.PrincipalClassification.ORGANIZATION_UNIT:
            ou = m.OrganizationUnit.decode(principal.principal)
            return (ou.msp_identifier == self.mspid
                    and self.is_valid(ident)
                    and self._has_ou(ident, ou.organizational_unit_identifier))
        return False

    # -- signing identity construction --
    def signing_identity(self, cert_pem: bytes,
                         key_pem: bytes) -> SigningIdentity:
        cert = deserialize_cert(cert_pem)
        return SigningIdentity(self.mspid, cert, key_pem, self._csp,
                               self.raw_messages)


class MspManager:
    """Routes serialized identities to the right MSP by mspid
    (reference: msp/mspmgrimpl.go)."""

    def __init__(self, msps: Sequence[Msp] = ()):
        self._msps: Dict[str, Msp] = {m_.mspid: m_ for m_ in msps}

    def add(self, msp: Msp) -> None:
        self._msps[msp.mspid] = msp

    def get(self, mspid: str) -> Optional[Msp]:
        return self._msps.get(mspid)

    def msps(self) -> List[Msp]:
        return list(self._msps.values())

    def deserialize_identity(self, serialized: bytes) -> Identity:
        sid = m.SerializedIdentity.decode(serialized)
        msp = self._msps.get(sid.mspid)
        if msp is None:
            raise MSPValidationError(f"unknown MSP {sid.mspid!r}")
        return msp.deserialize_identity(serialized)

    def validate(self, ident: Identity) -> None:
        msp = self._msps.get(ident.mspid)
        if msp is None:
            raise MSPValidationError(f"unknown MSP {ident.mspid!r}")
        msp.validate(ident)

    def satisfies_principal(self, ident: Identity,
                            principal: m.MSPPrincipal) -> bool:
        msp = self._msps.get(ident.mspid)
        return msp is not None and msp.satisfies_principal(ident, principal)
