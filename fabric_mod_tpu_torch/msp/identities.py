"""X.509 identities — the port's copy of fabric_mod_tpu/msp/identities.py
(reference: msp/identities.go).

An Identity wraps a certificate; `verify(msg, sig)` is hash-then-verify
like the reference (msp/identities.go:169-196), and `verify_item`
exposes the same check as a VerifyItem so a block's checks go to the
card in one batch.  `raw_messages` (the MSP's constructor argument; the
reference reads FABRIC_MOD_TPU_FUSED_HASH) makes `verify_item` carry the
raw message, so that e = SHA-256(m) is computed on the card in the same
call as the verify.
"""
from __future__ import annotations

import hashlib
from typing import Optional

from fabric_mod_tpu_torch.bccsp import x509
from fabric_mod_tpu_torch.bccsp.api import VerifyItem
from fabric_mod_tpu_torch.protos import messages as m


class Identity:
    def __init__(self, mspid: str, cert: x509.Certificate, csp,
                 raw_messages: bool = False):
        self.mspid = mspid
        self.cert = cert
        self._csp = csp
        self._raw_messages = raw_messages
        self._key = csp.key_import(cert.public_key().spki_pem(), "pem-pub")

    # -- serialization --
    def cert_pem(self) -> bytes:
        return self.cert.pem()

    def serialize(self) -> bytes:
        return m.SerializedIdentity(mspid=self.mspid,
                                    id_bytes=self.cert_pem()).encode()

    def ski(self) -> bytes:
        return self._key.ski()

    # -- attributes --
    def expires_at(self):
        return self.cert.not_valid_after_utc

    def organizational_units(self) -> list:
        return [ou.value for ou in self.cert.subject.get_attributes_for_oid(
            x509.NameOID.ORGANIZATIONAL_UNIT_NAME)]

    def common_name(self) -> str:
        cns = self.cert.subject.get_attributes_for_oid(x509.NameOID.COMMON_NAME)
        return cns[0].value if cns else ""

    # -- crypto --
    def digest_for(self, msg: bytes) -> bytes:
        return self._csp.hash(msg, "SHA256")

    def verify(self, msg: bytes, sig: bytes) -> bool:
        """Hash-then-verify (reference: msp/identities.go:169)."""
        return self._csp.verify(self._key, sig, self.digest_for(msg))

    def verify_item(self, msg: bytes, sig: bytes) -> Optional[VerifyItem]:
        """The same check as a batchable work item (every key here is
        P-256)."""
        if self._raw_messages:
            return VerifyItem(b"", sig, self._key.public_xy(), message=msg)
        return VerifyItem(self.digest_for(msg), sig, self._key.public_xy())


class SigningIdentity(Identity):
    def __init__(self, mspid: str, cert: x509.Certificate,
                 private_key_pem: bytes, csp, raw_messages: bool = False):
        super().__init__(mspid, cert, csp, raw_messages)
        self._priv = csp.key_import(private_key_pem, "pem-priv")

    def sign_message(self, msg: bytes) -> bytes:
        return self._csp.sign(self._priv, self.digest_for(msg))


def deserialize_cert(id_bytes: bytes) -> x509.Certificate:
    if id_bytes.lstrip().startswith(b"-----BEGIN"):
        return x509.load_pem_x509_certificate(id_bytes)
    return x509.load_der_x509_certificate(id_bytes)


def cert_fingerprint(cert: x509.Certificate) -> bytes:
    """SHA-256 of the certificate's original DER."""
    return hashlib.sha256(cert.der()).digest()
