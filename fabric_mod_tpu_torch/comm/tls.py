"""TLS material generation and certificate-expiration tracking.

The port's copy of fabric_mod_tpu/comm/tls.py (reference: common/crypto
— tlsgen's on-the-fly TLS CAs and TrackExpiration's warn-before-expiry
scan at common/crypto/expiration.go).

Issuance goes through the port's MSP CA library (msp/ca.py): every key
and serial number comes from the CA's `seed`, as the port's other CAs'
do.  TLS certificates carry serverAuth/clientAuth ExtendedKeyUsage and
SubjectAlternativeName entries (DNS names and IP addresses), which the
MSP CA's identity certificates do not carry and which OpenSSL's
host-name check needs.
"""
from __future__ import annotations

import datetime
import ipaddress
import os
from typing import Callable, List, Optional, Sequence, Tuple

from fabric_mod_tpu_torch.bccsp import sw, x509
from fabric_mod_tpu_torch.msp import ca as calib


class TlsCA:
    """A TLS-only CA (reference: common/crypto/tlsgen/ca.go).  `seed`
    makes its key and every key it issues."""

    def __init__(self, name: str = "tlsca", org: str = "tls",
                 seed: bytes = b"tlsca",
                 now: Optional[datetime.datetime] = None):
        self._ca = calib.CA(name, org, seed=seed, now=now)
        self._seed = seed + b"|tls|" + name.encode()

    @property
    def cert_pem(self) -> bytes:
        return self._ca.cert_pem()

    def issue(self, cn: str, sans: Sequence[str] = ("localhost",),
              server: bool = True, client: bool = True,
              valid_days: int = 365) -> Tuple[bytes, bytes]:
        """-> (certificate PEM, PKCS#8 key PEM) with the EKUs and SANs."""
        key = sw.PrivateKey.from_seed(self._seed + b"|" + cn.encode())
        now = self._ca.now
        names: List[object] = []
        for s in sans:
            try:
                names.append(x509.IPAddress(ipaddress.ip_address(s)))
            except ValueError:
                names.append(x509.DNSName(s))
        ekus = []
        if server:
            ekus.append(x509.ExtendedKeyUsageOID.SERVER_AUTH)
        if client:
            ekus.append(x509.ExtendedKeyUsageOID.CLIENT_AUTH)
        cert = (
            x509.CertificateBuilder()
            .subject_name(x509.Name([x509.NameAttribute(
                x509.NameOID.COMMON_NAME, cn)]))
            .issuer_name(self._ca.cert.subject)
            .public_key(key)
            .serial_number(self._ca._serial())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=valid_days))
            .add_extension(x509.BasicConstraints(ca=False,
                                                 path_length=None),
                           critical=True)
            .add_extension(x509.SubjectAlternativeName(names),
                           critical=False)
            .add_extension(x509.ExtendedKeyUsage(ekus), critical=False)
            .sign(self._ca.key))
        return cert.pem(), calib.key_pem(key)


def write_pems(dir_path: str, **pems: bytes) -> dict:
    """Write named PEMs to `<dir>/<name>.pem`; {name: path}."""
    os.makedirs(dir_path, exist_ok=True)
    out = {}
    for name, data in pems.items():
        path = os.path.join(dir_path, f"{name}.pem")
        with open(path, "wb") as f:
            f.write(data)
        out[name] = path
    return out


def track_expiration(cert_pems: Sequence[bytes],
                     warn: Callable[[str], None],
                     now: Optional[datetime.datetime] = None,
                     warn_within_days: int = 7) -> List[str]:
    """Warn for certificates expired or expiring within
    `warn_within_days` (reference: common/crypto/expiration.go
    TrackExpiration); the warned subjects."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    flagged = []
    for pem in cert_pems:
        cert = x509.load_pem_x509_certificate(pem)
        subject = cert.subject.rfc4514_string()
        left = cert.not_valid_after_utc - now
        if left.total_seconds() <= 0:
            warn(f"certificate {subject} has expired")
            flagged.append(subject)
        elif left <= datetime.timedelta(days=warn_within_days):
            warn(f"certificate {subject} expires in {left}")
            flagged.append(subject)
    return flagged
