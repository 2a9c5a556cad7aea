"""X.509 issue and parse for the certificate shapes the MSP uses.

The port's copy of fabric_mod_tpu/bccsp/_x509fallback.py.  It is the
only X.509 layer the port has: the port never imports the
`cryptography` wheel, so it parses and issues certificates the same way
on every machine.  The shapes covered are those a Fabric CA mints: X.509
v3, EC P-256 keys, ecdsa-with-SHA256 signatures, names of string
attributes (CN, O, OU, ...), BasicConstraints and KeyUsage, and the TLS
certificates' SubjectAlternativeName (DNS names and IP addresses) and
ExtendedKeyUsage (comm/tls.py issues them so that OpenSSL's host-name
check passes).  A non-critical extension of another kind is dropped; a
critical one, or anything else outside these shapes, raises
`UnsupportedCertificate`.

A parsed `Certificate` keeps the exact DER it was read from: its
fingerprint (msp/identities.cert_fingerprint) and its PEM come from
those bytes, never from a re-encoding.  Issued certificates follow RFC
5280: UTCTime before 2050, GeneralizedTime from then on.
"""
from __future__ import annotations

import datetime
import hashlib
import ipaddress
from typing import List, Optional, Sequence

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.bccsp.sw import (
    DerReader, OID_ECDSA_SHA256, der_int, der_oid, der_seq, der_tlv)


class UnsupportedCertificate(ValueError):
    """A certificate outside the shapes this module covers."""


class ObjectIdentifier:
    def __init__(self, dotted: str):
        self.dotted_string = dotted

    def __eq__(self, other):
        return (isinstance(other, ObjectIdentifier)
                and self.dotted_string == other.dotted_string)

    def __hash__(self):
        return hash(self.dotted_string)

    def __repr__(self):
        return f"<ObjectIdentifier({self.dotted_string})>"


class NameOID:
    COMMON_NAME = ObjectIdentifier("2.5.4.3")
    ORGANIZATION_NAME = ObjectIdentifier("2.5.4.10")
    ORGANIZATIONAL_UNIT_NAME = ObjectIdentifier("2.5.4.11")
    COUNTRY_NAME = ObjectIdentifier("2.5.4.6")
    LOCALITY_NAME = ObjectIdentifier("2.5.4.7")
    STATE_OR_PROVINCE_NAME = ObjectIdentifier("2.5.4.8")


_RFC4514_SHORT = {
    "2.5.4.3": "CN", "2.5.4.10": "O", "2.5.4.11": "OU",
    "2.5.4.6": "C", "2.5.4.7": "L", "2.5.4.8": "ST",
}

# DirectoryString tags a Name attribute may carry: UTF8String,
# PrintableString, IA5String
_STRING_TAGS = (0x0C, 0x13, 0x16)


# --- Names -----------------------------------------------------------------

class NameAttribute:
    def __init__(self, oid_: ObjectIdentifier, value: str):
        self.oid = oid_
        self.value = value


class Name:
    """An RDNSequence.  A parsed Name keeps its DER (`public_bytes`
    returns it unchanged); a built one encodes one UTF8String
    attribute per RDN."""

    def __init__(self, attributes, der: Optional[bytes] = None):
        self._attrs: List[NameAttribute] = list(attributes)
        self._der = der

    def get_attributes_for_oid(self, oid_: ObjectIdentifier):
        return [a for a in self._attrs if a.oid == oid_]

    def public_bytes(self) -> bytes:
        if self._der is not None:
            return self._der
        rdns = []
        for a in self._attrs:
            atv = der_seq(der_oid(a.oid.dotted_string),
                          der_tlv(0x0C, a.value.encode()))
            rdns.append(der_tlv(0x31, atv))
        return der_seq(*rdns)

    def rfc4514_string(self) -> str:
        parts = []
        for a in reversed(self._attrs):
            short = _RFC4514_SHORT.get(a.oid.dotted_string,
                                       a.oid.dotted_string)
            parts.append(f"{short}={a.value}")
        return ",".join(parts)

    def __eq__(self, other):
        return (isinstance(other, Name)
                and self.public_bytes() == other.public_bytes())

    def __hash__(self):
        return hash(self.public_bytes())

    def __repr__(self):
        return f"<Name({self.rfc4514_string()})>"


def _parse_name(der: bytes) -> Name:
    attrs = []
    rdnseq = DerReader(der).reader(0x30)
    while not rdnseq.done():
        rdn = rdnseq.reader(0x31)
        while not rdn.done():
            atv = rdn.reader(0x30)
            oid_der = atv.value(0x06)
            tag, a, b = atv.read()
            if tag not in _STRING_TAGS:
                raise UnsupportedCertificate(
                    f"Name attribute string tag 0x{tag:02x}")
            attrs.append(NameAttribute(
                _oid_from_der_body(oid_der),
                atv.buf[a:b].decode("utf-8")))
    return Name(attrs, der)


def _oid_from_der_body(body: bytes) -> ObjectIdentifier:
    arcs = [body[0] // 40, body[0] % 40]
    acc = 0
    for byte in body[1:]:
        acc = (acc << 7) | (byte & 0x7F)
        if not byte & 0x80:
            arcs.append(acc)
            acc = 0
    return ObjectIdentifier(".".join(map(str, arcs)))


# --- Extensions ------------------------------------------------------------

class ExtensionNotFound(Exception):
    pass


class BasicConstraints:
    oid = ObjectIdentifier("2.5.29.19")

    def __init__(self, ca: bool, path_length: Optional[int]):
        self.ca = ca
        self.path_length = path_length


_KU_FIELDS = ("digital_signature", "content_commitment",
              "key_encipherment", "data_encipherment", "key_agreement",
              "key_cert_sign", "crl_sign", "encipher_only",
              "decipher_only")


class KeyUsage:
    oid = ObjectIdentifier("2.5.29.15")

    def __init__(self, digital_signature, content_commitment,
                 key_encipherment, data_encipherment, key_agreement,
                 key_cert_sign, crl_sign, encipher_only, decipher_only):
        self.digital_signature = digital_signature
        self.content_commitment = content_commitment
        self.key_encipherment = key_encipherment
        self.data_encipherment = data_encipherment
        self.key_agreement = key_agreement
        self.key_cert_sign = key_cert_sign
        self.crl_sign = crl_sign
        self.encipher_only = encipher_only
        self.decipher_only = decipher_only


class DNSName:
    """A SubjectAlternativeName dNSName ([2] IA5String)."""

    def __init__(self, value: str):
        self.value = value

    def __eq__(self, other):
        return isinstance(other, DNSName) and self.value == other.value

    def __hash__(self):
        return hash(("dns", self.value))

    def __repr__(self):
        return f"<DNSName(value={self.value!r})>"


class IPAddress:
    """A SubjectAlternativeName iPAddress ([7] OCTET STRING)."""

    def __init__(self, value):
        self.value = ipaddress.ip_address(value)

    def __eq__(self, other):
        return isinstance(other, IPAddress) and self.value == other.value

    def __hash__(self):
        return hash(("ip", self.value))

    def __repr__(self):
        return f"<IPAddress(value={self.value})>"


class SubjectAlternativeName:
    oid = ObjectIdentifier("2.5.29.17")

    def __init__(self, names: Sequence):
        self._names = list(names)

    def __iter__(self):
        return iter(self._names)

    def get_values_for_type(self, kind) -> list:
        return [n.value for n in self._names if isinstance(n, kind)]


class ExtendedKeyUsageOID:
    SERVER_AUTH = ObjectIdentifier("1.3.6.1.5.5.7.3.1")
    CLIENT_AUTH = ObjectIdentifier("1.3.6.1.5.5.7.3.2")


class ExtendedKeyUsage:
    oid = ObjectIdentifier("2.5.29.37")

    def __init__(self, usages: Sequence[ObjectIdentifier]):
        self._usages = list(usages)

    def __iter__(self):
        return iter(self._usages)


class Extension:
    def __init__(self, oid_, critical: bool, value):
        self.oid = oid_
        self.critical = critical
        self.value = value


class Extensions:
    def __init__(self, exts: List[Extension]):
        self._exts = exts

    def __iter__(self):
        return iter(self._exts)

    def get_extension_for_class(self, cls) -> Extension:
        matches = [e for e in self._exts if isinstance(e.value, cls)]
        if not matches:
            raise ExtensionNotFound(f"no {cls.__name__} extension")
        if len(matches) > 1:
            raise ValueError(f"duplicate {cls.__name__} extension")
        return matches[0]


def _encode_extension_value(ext) -> bytes:
    if isinstance(ext, BasicConstraints):
        body = b""
        if ext.ca:
            body += der_tlv(0x01, b"\xff")
        if ext.path_length is not None:
            body += der_int(ext.path_length)
        return der_seq(body) if body else der_seq()
    if isinstance(ext, KeyUsage):
        bits = [getattr(ext, f) for f in _KU_FIELDS]
        while bits and not bits[-1]:
            bits.pop()
        if not bits:
            return der_tlv(0x03, b"\x00")
        nbytes = (len(bits) + 7) // 8
        val = 0
        for i, b in enumerate(bits):
            if b:
                val |= 1 << (nbytes * 8 - 1 - i)
        unused = nbytes * 8 - len(bits)
        return der_tlv(0x03, bytes([unused])
                       + val.to_bytes(nbytes, "big"))
    if isinstance(ext, SubjectAlternativeName):
        names = []
        for n in ext:
            if isinstance(n, DNSName):
                names.append(der_tlv(0x82, n.value.encode("ascii")))
            elif isinstance(n, IPAddress):
                names.append(der_tlv(0x87, n.value.packed))
            else:
                raise UnsupportedCertificate(f"general name {n!r}")
        return der_seq(*names)
    if isinstance(ext, ExtendedKeyUsage):
        return der_seq(*(der_oid(u.dotted_string) for u in ext))
    raise UnsupportedCertificate(f"extension {type(ext).__name__}")


def _decode_extension(oid_: ObjectIdentifier, critical: bool,
                      value: bytes) -> Optional[Extension]:
    dotted = oid_.dotted_string
    if dotted == "2.5.29.19":                     # BasicConstraints
        rd = DerReader(value).reader(0x30)
        ca, plen = False, None
        if not rd.done() and rd.peek_tag() == 0x01:
            ca = rd.value(0x01) != b"\x00"
        if not rd.done() and rd.peek_tag() == 0x02:
            plen = int.from_bytes(rd.value(0x02), "big")
        return Extension(oid_, critical, BasicConstraints(ca, plen))
    if dotted == "2.5.29.15":                     # KeyUsage
        bits_der = DerReader(value).value(0x03)
        unused, body = bits_der[0], bits_der[1:]
        nbits = len(body) * 8 - unused
        flags = []
        for i, _field in enumerate(_KU_FIELDS):
            on = False
            if i < nbits:
                on = bool(body[i // 8] & (0x80 >> (i % 8)))
            flags.append(on)
        return Extension(oid_, critical, KeyUsage(*flags))
    if dotted == "2.5.29.17":                     # SubjectAlternativeName
        rd = DerReader(value).reader(0x30)
        names = []
        while not rd.done():
            tag, a, b = rd.read()
            if tag == 0x82:
                names.append(DNSName(rd.buf[a:b].decode("ascii")))
            elif tag == 0x87:
                names.append(IPAddress(bytes(rd.buf[a:b])))
            elif critical:
                raise UnsupportedCertificate(
                    f"critical SubjectAlternativeName with tag 0x{tag:02x}")
        return Extension(oid_, critical, SubjectAlternativeName(names))
    if dotted == "2.5.29.37":                     # ExtendedKeyUsage
        rd = DerReader(value).reader(0x30)
        usages = []
        while not rd.done():
            usages.append(_oid_from_der_body(rd.value(0x06)))
        return Extension(oid_, critical, ExtendedKeyUsage(usages))
    if critical:
        raise UnsupportedCertificate(f"critical extension {dotted}")
    return None                                   # tolerated, dropped


# --- Certificates ----------------------------------------------------------

def _encode_time(dt: datetime.datetime) -> bytes:
    """RFC 5280 4.1.2.5: UTCTime through 2049, GeneralizedTime after."""
    dt = dt.astimezone(datetime.timezone.utc)
    if dt.year < 2050:
        return der_tlv(0x17, dt.strftime("%y%m%d%H%M%SZ").encode())
    return der_tlv(0x18, dt.strftime("%Y%m%d%H%M%SZ").encode())


def _decode_time(tag: int, body: bytes) -> datetime.datetime:
    text = body.decode()
    if tag == 0x18:                               # GeneralizedTime
        dt = datetime.datetime.strptime(text, "%Y%m%d%H%M%SZ")
    elif tag == 0x17:                             # UTCTime
        dt = datetime.datetime.strptime(text, "%y%m%d%H%M%SZ")
        if dt.year >= 2050:                       # RFC 5280: YY >= 50 is 19YY
            dt = dt.replace(year=dt.year - 100)
    else:
        raise UnsupportedCertificate(f"time tag 0x{tag:02x}")
    return dt.replace(tzinfo=datetime.timezone.utc)


class PublicKey:
    """A certificate's P-256 subject key."""

    def __init__(self, x: int, y: int):
        self.x, self.y = x, y

    def public_xy(self) -> bytes:
        return self.x.to_bytes(32, "big") + self.y.to_bytes(32, "big")

    def spki_pem(self) -> bytes:
        return sw.pem_encode("PUBLIC KEY", sw.spki_der(self.x, self.y))

    def verify_signature(self, signature: bytes, message: bytes) -> bool:
        """ecdsa-with-SHA256 over `message` (a child's TBS bytes)."""
        return sw.verify_certificate_signature(self.x, self.y, signature,
                                               message)


class Certificate:
    """A parsed certificate with the attributes the MSP reads."""

    def __init__(self, der: bytes, tbs: bytes, serial: int,
                 issuer: Name, subject: Name,
                 not_before: datetime.datetime,
                 not_after: datetime.datetime,
                 pub: PublicKey, signature: bytes,
                 extensions: Extensions):
        self._der = der
        self.tbs_certificate_bytes = tbs
        self.serial_number = serial
        self.issuer = issuer
        self.subject = subject
        self.not_valid_before_utc = not_before
        self.not_valid_after_utc = not_after
        self._pub = pub
        self.signature = signature
        self.extensions = extensions

    def public_key(self) -> PublicKey:
        return self._pub

    def der(self) -> bytes:
        """The exact DER this certificate was parsed from."""
        return self._der

    def pem(self) -> bytes:
        return sw.pem_encode("CERTIFICATE", self._der)

    def __eq__(self, other):
        return isinstance(other, Certificate) and self._der == other._der

    def __hash__(self):
        return hash(self._der)


def _read_element(rd: DerReader, expect_tag: int = None):
    """Read one TLV, returning (tag, value_span, whole_tlv_bytes)."""
    start = rd.off
    tag, a, b = rd.read(expect_tag)
    return tag, rd.buf[a:b], rd.buf[start:b]


def _expect_ecdsa_sha256(alg: DerReader) -> None:
    if alg.value(0x06) != der_oid(OID_ECDSA_SHA256)[2:]:
        raise UnsupportedCertificate("non-ecdsa-with-SHA256 certificate")


def load_der_x509_certificate(data: bytes) -> Certificate:
    data = bytes(data)
    cert = DerReader(data).reader(0x30)
    _tag, _tbs_val, tbs = _read_element(cert, 0x30)
    _expect_ecdsa_sha256(cert.reader(0x30))
    sig_bits = cert.value(0x03)
    if not sig_bits or sig_bits[0] != 0:
        raise ValueError("bad signature BIT STRING")
    signature = sig_bits[1:]

    rd = DerReader(tbs).reader(0x30)
    if rd.peek_tag() == 0xA0:                     # [0] EXPLICIT version
        ver = rd.reader(0xA0)
        if ver.value(0x02) != b"\x02":
            raise UnsupportedCertificate("non-v3 certificate")
    serial = int.from_bytes(rd.value(0x02), "big")
    _expect_ecdsa_sha256(rd.reader(0x30))
    _, _, issuer_der = _read_element(rd, 0x30)
    issuer = _parse_name(issuer_der)
    validity = rd.reader(0x30)
    t1, a1, b1 = validity.read()
    not_before = _decode_time(t1, validity.buf[a1:b1])
    t2, a2, b2 = validity.read()
    not_after = _decode_time(t2, validity.buf[a2:b2])
    _, _, subject_der = _read_element(rd, 0x30)
    subject = _parse_name(subject_der)
    _, _, spki = _read_element(rd, 0x30)
    pub = PublicKey(*sw.parse_spki(spki))
    exts: List[Extension] = []
    while not rd.done():
        tag, val_a, val_b = rd.read()
        if tag != 0xA3:
            continue                              # issuer/subject UIDs
        ext_seq = DerReader(rd.buf, val_a, val_b).reader(0x30)
        while not ext_seq.done():
            one = ext_seq.reader(0x30)
            eoid = _oid_from_der_body(one.value(0x06))
            critical = False
            if one.peek_tag() == 0x01:
                critical = one.value(0x01) != b"\x00"
            value = one.value(0x04)
            got = _decode_extension(eoid, critical, value)
            if got is not None:
                exts.append(got)
    return Certificate(data, tbs, serial, issuer, subject,
                       not_before, not_after, pub, signature,
                       Extensions(exts))


def load_pem_x509_certificate(data: bytes) -> Certificate:
    return load_der_x509_certificate(sw.pem_decode(data))


class CertificateBuilder:
    """Chainable builder; `sign` produces DER that any X.509 parser
    reads, signed by RFC 6979 (so a seeded key gives the same bytes)."""

    def __init__(self, subject=None, issuer=None, pub=None, serial=None,
                 nvb=None, nva=None, exts=None):
        self._subject = subject
        self._issuer = issuer
        self._pub = pub
        self._serial = serial
        self._nvb = nvb
        self._nva = nva
        self._exts = exts or []

    def _with(self, **kw) -> "CertificateBuilder":
        fields = dict(subject=self._subject, issuer=self._issuer,
                      pub=self._pub, serial=self._serial, nvb=self._nvb,
                      nva=self._nva, exts=self._exts)
        fields.update(kw)
        return CertificateBuilder(**fields)

    def subject_name(self, name: Name):
        return self._with(subject=name)

    def issuer_name(self, name: Name):
        return self._with(issuer=name)

    def public_key(self, key: sw.PrivateKey):
        """The subject's key, given as its private key (the CA holds
        the pair it issues for)."""
        return self._with(pub=key.public_point())

    def serial_number(self, serial: int):
        return self._with(serial=serial)

    def not_valid_before(self, dt):
        return self._with(nvb=dt)

    def not_valid_after(self, dt):
        return self._with(nva=dt)

    def add_extension(self, ext, critical: bool):
        return self._with(exts=self._exts + [(ext, critical)])

    def sign(self, private_key: sw.PrivateKey) -> Certificate:
        if None in (self._subject, self._issuer, self._pub,
                    self._serial, self._nvb, self._nva):
            raise ValueError("incomplete certificate builder")
        if self._nvb >= self._nva:
            raise ValueError("not_valid_before must precede not_valid_after")
        ext_ders = []
        for ext, critical in self._exts:
            body = der_oid(ext.oid.dotted_string)
            if critical:
                body += der_tlv(0x01, b"\xff")
            body += der_tlv(0x04, _encode_extension_value(ext))
            ext_ders.append(der_seq(body))
        sig_alg = der_seq(der_oid(OID_ECDSA_SHA256))
        tbs = der_seq(
            der_tlv(0xA0, der_int(2)),            # version v3
            der_int(self._serial),
            sig_alg,
            self._issuer.public_bytes(),
            der_seq(_encode_time(self._nvb), _encode_time(self._nva)),
            self._subject.public_bytes(),
            sw.spki_der(*self._pub),
            der_tlv(0xA3, der_seq(*ext_ders)),
        )
        sig = private_key.sign(hashlib.sha256(tbs).digest())
        der = der_seq(tbs, sig_alg, der_tlv(0x03, b"\x00" + sig))
        return load_der_x509_certificate(der)
