"""Certificate authority helpers — the port's copy of
fabric_mod_tpu/msp/ca.py (reference: internal/cryptogen/ca/ca.go).

Everything is made from a seed: keys come from
`sw.PrivateKey.from_seed`, serial numbers from a generator seeded with
the same bytes, and signatures are RFC 6979, so one seed and one `now`
give the same certificates byte for byte on any machine.
"""
from __future__ import annotations

import datetime
import hashlib
import random
from typing import Optional

from fabric_mod_tpu_torch.bccsp import sw, x509

NameOID = x509.NameOID


def _name(cn: str, org: Optional[str] = None, ou: Optional[list] = None):
    attrs = [x509.NameAttribute(NameOID.COMMON_NAME, cn)]
    if org:
        attrs.append(x509.NameAttribute(NameOID.ORGANIZATION_NAME, org))
    for u in ou or []:
        attrs.append(x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME, u))
    return x509.Name(attrs)


def _key_usage(ca: bool) -> x509.KeyUsage:
    return x509.KeyUsage(
        digital_signature=True, key_cert_sign=ca, crl_sign=ca,
        content_commitment=False, key_encipherment=False,
        data_encipherment=False, key_agreement=False,
        encipher_only=False, decipher_only=False)


class CA:
    """A self-signed signing CA that issues EC P-256 certificates.

    `seed` determines every key and serial number it makes; `now`
    (default: the current time) anchors the validity windows."""

    def __init__(self, name: str, org: str = "org", seed: bytes = b"ca",
                 valid_days: int = 3650,
                 now: Optional[datetime.datetime] = None):
        self._seed = seed + b"|" + name.encode()
        self._serials = random.Random(
            hashlib.sha256(b"serials|" + self._seed).digest())
        self.now = now or datetime.datetime.now(datetime.timezone.utc)
        self.key = sw.PrivateKey.from_seed(self._seed)
        subject = _name(name, org)
        self.cert = (
            x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(self.key)
            .serial_number(self._serial())
            .not_valid_before(self.now - datetime.timedelta(minutes=5))
            .not_valid_after(self.now + datetime.timedelta(days=valid_days))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .add_extension(_key_usage(True), critical=True)
            .sign(self.key))

    def _serial(self) -> int:
        # 63 bits keeps the INTEGER a single positive form
        return self._serials.getrandbits(63) | 1

    def issue(self, cn: str, org: Optional[str] = None,
              ous: Optional[list] = None, is_ca: bool = False,
              valid_days: int = 3650, not_after=None, not_before=None,
              key: Optional[sw.PrivateKey] = None):
        """Issue a cert; returns (cert, private_key).  The key defaults
        to one derived from the CA's seed and `cn`.

        An explicit past `not_after` yields a genuinely expired cert:
        `not_valid_before` is pushed before it so builder validation
        holds."""
        key = key or sw.PrivateKey.from_seed(self._seed + b"|" + cn.encode())
        nva = not_after or self.now + datetime.timedelta(days=valid_days)
        nvb = not_before or min(self.now - datetime.timedelta(minutes=5),
                                nva - datetime.timedelta(minutes=1))
        builder = (
            x509.CertificateBuilder()
            .subject_name(_name(cn, org, ous))
            .issuer_name(self.cert.subject)
            .public_key(key)
            .serial_number(self._serial())
            .not_valid_before(nvb)
            .not_valid_after(nva)
            .add_extension(x509.BasicConstraints(ca=is_ca, path_length=None),
                           critical=True))
        if not is_ca:
            builder = builder.add_extension(_key_usage(False), critical=True)
        return builder.sign(self.key), key

    def cert_pem(self) -> bytes:
        return self.cert.pem()


def key_pem(key: sw.PrivateKey) -> bytes:
    """PKCS#8 PEM of a private key."""
    return sw.pem_encode("PRIVATE KEY", sw.pkcs8_der(key))


def cert_pem(cert: x509.Certificate) -> bytes:
    return cert.pem()
