"""Epoch-based credential revocation for idemix.

The port's copy of fabric_mod_tpu/idemix/revocation.py over the port's
own P-256 signer (bccsp/sw.py); it never imports `cryptography`.  The
Revocation Authority's key may be given (a seeded fixture), else it is
drawn from `secrets`.

(reference: idemix/revocation_authority.go — the Revocation Authority
signs per-epoch Credential Revocation Information (CRI) with an ECDSA
key; Signature.Ver (signature.go:243) checks the non-revocation
evidence against the CRI before accepting a presentation.)

Design (and its honest delta from the reference): the reference ships
ALG_NO_REVOCATION — the signed CRI exists but never names a revoked
credential, so nothing is enforceable.  Here the CRI carries the
DIGESTS of revoked revocation handles, and enforcement is real: a
presentation made under a CRI-enforcing verifier must DISCLOSE its
revocation-handle attribute; the verifier checks the proof binds the
handle into the credential (the ordinary disclosed-attribute Schnorr
relation) and that its digest is not in the CRI.  The privacy cost —
presentations by one credential become linkable to the verifier via
the disclosed handle — is the zero-egress trade for the reference's
(unshipped) accumulator math, and is documented at the MSP layer.

Epoch freshness: verifiers pin the epoch they expect; a CRI for an
older epoch (a replayed, pre-revocation list) is rejected.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import secrets
from typing import List, Optional

from fabric_mod_tpu_torch.bccsp import sw


def rh_digest(rh: int) -> str:
    """Digest under which a revocation handle appears in the CRI."""
    return hashlib.sha256(
        rh.to_bytes(32, "big", signed=False)).hexdigest()


@dataclasses.dataclass
class CRI:
    """Credential Revocation Information: one epoch's signed list
    (reference: the CRI proto of revocation_authority.go)."""
    epoch: int
    revoked_digests: List[str]
    signature_hex: str = ""

    def __post_init__(self):
        self._revoked_set = set(self.revoked_digests)

    def signed_payload(self) -> bytes:
        return json.dumps({"epoch": self.epoch,
                           "revoked": sorted(self.revoked_digests)},
                          sort_keys=True).encode()

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "revoked": sorted(self.revoked_digests),
                "sig": self.signature_hex}

    @classmethod
    def from_dict(cls, d: dict) -> "CRI":
        return cls(epoch=int(d["epoch"]),
                   revoked_digests=list(d["revoked"]),
                   signature_hex=str(d["sig"]))

    def is_revoked(self, rh: int) -> bool:
        return rh_digest(rh) in self._revoked_set


class RevocationAuthority:
    """Holds the RA key, tracks revoked handles, signs CRIs
    (reference: revocation_authority.go NewRevocationAuthority +
    Sign)."""

    def __init__(self, key: Optional[sw.PrivateKey] = None):
        self._key = key if key is not None else \
            sw.PrivateKey(secrets.randbelow(sw.N - 1) + 1)
        self._revoked: set = set()
        self.epoch = 0

    @property
    def public_pem(self) -> bytes:
        return sw.pem_encode("PUBLIC KEY",
                             sw.spki_der(*self._key.public_point()))

    def revoke(self, rh: int) -> None:
        """Revoking advances the epoch: every verifier pinned to the
        new epoch immediately refuses the old list."""
        self._revoked.add(rh_digest(rh))
        self.epoch += 1

    def cri(self) -> CRI:
        # always the RA's CURRENT epoch: a caller-chosen epoch would
        # be a signing oracle for future-epoch lists carrying a
        # pre-revocation view
        out = CRI(epoch=self.epoch,
                  revoked_digests=sorted(self._revoked))
        digest = hashlib.sha256(out.signed_payload()).digest()
        out.signature_hex = self._key.sign(digest).hex()
        return out


def verify_cri(cri: CRI, ra_public_pem: bytes,
               expected_epoch: Optional[int] = None) -> bool:
    """RA signature + epoch pin (reference: the CRI checks inside
    signature.go Ver)."""
    if expected_epoch is not None and cri.epoch != expected_epoch:
        return False
    try:
        x, y = sw.parse_spki(sw.pem_decode(ra_public_pem))
        sig = bytes.fromhex(cri.signature_hex)
    except (ValueError, TypeError):
        return False
    # ECDSA over SHA-256(payload), without the low-S rule: the
    # reference's RA does not normalise s
    return sw.verify_certificate_signature(x, y, sig, cri.signed_payload())
