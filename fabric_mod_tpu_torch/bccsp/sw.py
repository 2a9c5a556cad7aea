"""Pure-python P-256 ECDSA — the port's software reference.

The port's own copy of what it needs from fabric_mod_tpu/bccsp/sw.py and
bccsp/_ecfallback.py: key generation from a seed, RFC 6979 signing with
the low-S rule, verification, and strict DER encode/decode of the
ECDSA-Sig-Value; the DER, PEM, SubjectPublicKeyInfo and PKCS#8
encodings of keys; and `SwCSP`, the provider surface identities use.
It never imports the `cryptography` wheel, so the fixtures, the MSP and
the software verdicts that the device path is held against behave the
same on every machine.  Slow (about a millisecond per operation) and
not constant-time: fixtures, host-side identity checks and reference
verdicts, never the batch verify path.
"""
from __future__ import annotations

import base64
import hashlib
import hmac

import numpy as np

# NIST P-256 domain parameters (public constants).
P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
GX = 0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
GY = 0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
G = (GX, GY)

LOW_S_MAX = N // 2


# --- affine / Jacobian curve arithmetic (python ints; None = identity) -----

def point_add(p1, p2):
    """Affine addition (None is the identity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1 - 3) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _jac_double(p):
    """Jacobian doubling for a = -3."""
    if p is None:
        return None
    x, y, z = p
    if y == 0:
        return None
    ysq = y * y % P
    s = 4 * x * ysq % P
    zz = z * z % P
    m = 3 * (x - zz) * (x + zz) % P
    nx = (m * m - 2 * s) % P
    ny = (m * (s - nx) - 8 * ysq * ysq) % P
    nz = 2 * y * z % P
    return (nx, ny, nz)


def _jac_add_affine(p, q):
    """Jacobian p + affine q (mixed addition)."""
    if q is None:
        return p
    if p is None:
        return (q[0], q[1], 1)
    x1, y1, z1 = p
    x2, y2 = q
    z1z1 = z1 * z1 % P
    u2 = x2 * z1z1 % P
    s2 = y2 * z1 * z1z1 % P
    if u2 == x1:
        if s2 == y1 % P:
            return _jac_double(p)
        return None
    h = (u2 - x1) % P
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    rr = 2 * (s2 - y1) % P
    v = x1 * i % P
    nx = (rr * rr - j - 2 * v) % P
    ny = (rr * (v - nx) - 2 * y1 * j) % P
    nz = 2 * z1 * h % P
    return (nx, ny, nz)


def _jac_add(p, q):
    """General Jacobian addition."""
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return None
        return _jac_double(p)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    rr = 2 * (s2 - s1) % P
    v = u1 * i % P
    nx = (rr * rr - j - 2 * v) % P
    ny = (rr * (v - nx) - 2 * s1 * j) % P
    nz = 2 * z1 * z2 * h % P
    return (nx, ny, nz)


def _jac_to_affine(p):
    if p is None:
        return None
    zi = pow(p[2], -1, P)
    zi2 = zi * zi % P
    return (p[0] * zi2 % P, p[1] * zi2 * zi % P)


def _window_row(pt):
    """[pt, 2*pt, ..., 15*pt] in affine (a 4-bit window table)."""
    row = [pt]
    for _ in range(14):
        row.append(point_add(row[-1], pt))
    return row


class _Comb:
    """Fixed-base comb for G: 64 rows, row i holding the 1..15 multiples
    of 2^(4i)*G, so k*G is ~60 mixed additions and no doublings.  Built
    on first use."""

    rows = None

    @classmethod
    def get(cls):
        if cls.rows is None:
            rows, base = [], G
            for _ in range(64):
                row = _window_row(base)
                rows.append(row)
                base = point_add(row[-1], base)      # 16 * base
            cls.rows = rows
        return cls.rows


def _mul_g_jac(k: int):
    acc = None
    for row in _Comb.get():
        nib = k & 0xF
        if nib:
            acc = _jac_add_affine(acc, row[nib - 1])
        k >>= 4
        if not k:
            break
    return acc


def _mul_window_jac(k: int, row):
    acc = None
    for shift in range(252, -4, -4):
        if acc is not None:
            acc = _jac_double(_jac_double(_jac_double(_jac_double(acc))))
        nib = (k >> shift) & 0xF
        if nib:
            acc = _jac_add_affine(acc, row[nib - 1])
    return acc


def point_mul(k: int, pt):
    """k * pt (affine in, affine out; None is the identity)."""
    if pt is None or k % N == 0:
        return None
    k %= N
    if pt == G:
        return _jac_to_affine(_mul_g_jac(k))
    return _jac_to_affine(_mul_window_jac(k, _window_row(pt)))


def on_curve(x: int, y: int) -> bool:
    return (0 <= x < P and 0 <= y < P
            and (y * y - (x * x * x - 3 * x + B)) % P == 0)


# --- DER ECDSA-Sig-Value ----------------------------------------------------

def encode_dss_signature(r: int, s: int) -> bytes:
    def integer(v: int) -> bytes:
        if v < 0:
            raise ValueError("negative integer in signature")
        body = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
        if body[0] & 0x80:
            body = b"\x00" + body
        return b"\x02" + bytes([len(body)]) + body
    body = integer(r) + integer(s)
    if len(body) >= 0x80:
        raise ValueError("signature too large for short-form DER")
    return b"\x30" + bytes([len(body)]) + body


def decode_dss_signature(sig: bytes):
    """Strict DER decode (short-form lengths, minimal positive INTEGERs,
    no trailing bytes) — grammar-equivalent to der.decode_der_batch."""
    ln = len(sig)
    if ln < 8 or ln > 72 or sig[0] != 0x30:
        raise ValueError("invalid ECDSA-Sig-Value DER")
    if sig[1] >= 0x80 or sig[1] + 2 != ln:
        raise ValueError("invalid ECDSA-Sig-Value DER")

    def integer(off: int):
        if off + 2 > ln or sig[off] != 0x02:
            raise ValueError("invalid ECDSA-Sig-Value DER")
        ilen = sig[off + 1]
        end = off + 2 + ilen
        if ilen < 1 or ilen > 33 or end > ln:
            raise ValueError("invalid ECDSA-Sig-Value DER")
        body = sig[off + 2:end]
        if body[0] & 0x80:
            raise ValueError("negative INTEGER")
        if body[0] == 0 and ilen > 1 and body[1] < 0x80:
            raise ValueError("non-minimal INTEGER")
        if ilen == 33 and body[0] != 0:
            raise ValueError("INTEGER too wide")
        return int.from_bytes(body, "big"), end

    r, off = integer(2)
    s, off = integer(off)
    if off != ln:
        raise ValueError("trailing garbage after ECDSA-Sig-Value")
    return r, s


# --- RFC 6979 deterministic nonce ------------------------------------------

def _rfc6979_k(d: int, e: int) -> int:
    x = d.to_bytes(32, "big")
    h1 = (e % N).to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()


# --- keys, sign, verify -----------------------------------------------------

class PrivateKey:
    """A P-256 signing key."""

    def __init__(self, d: int):
        if not 1 <= d < N:
            raise ValueError("private scalar out of range")
        self.d = d
        self._xy = None

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivateKey":
        """Deterministic key: d = SHA-256(seed) mod (n-1) + 1."""
        e = int.from_bytes(hashlib.sha256(b"p256-key|" + seed).digest(),
                           "big")
        return cls(e % (N - 1) + 1)

    def public_point(self):
        if self._xy is None:
            self._xy = point_mul(self.d, G)
        return self._xy

    def public_xy(self) -> bytes:
        """64 bytes x‖y (the VerifyItem key encoding)."""
        x, y = self.public_point()
        return x.to_bytes(32, "big") + y.to_bytes(32, "big")

    def sign(self, digest: bytes) -> bytes:
        """RFC 6979 ECDSA over a 32-byte digest, normalised to low S
        (the reference's rule: s -> n - s when s > n/2)."""
        e = int.from_bytes(digest[:32], "big")
        k = _rfc6979_k(self.d, e)
        while True:
            r = point_mul(k, G)[0] % N
            s = pow(k, -1, N) * (e + r * self.d) % N
            if r and s:
                if s > LOW_S_MAX:
                    s = N - s
                return encode_dss_signature(r, s)
            k = (k + 1) % N or 1            # astronomically unlikely


class _WindowCache:
    """Per-public-key 4-bit window tables: identities verify many
    messages, so one 15-entry table per key amortises to nothing."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self._rows: dict = {}

    def row(self, pt):
        got = self._rows.get(pt)
        if got is None:
            if len(self._rows) >= self.cap:
                self._rows.clear()
            got = self._rows[pt] = _window_row(pt)
        return got


_WINDOWS = _WindowCache()


def _equation_holds(x: int, y: int, r: int, s: int, e: int) -> bool:
    """The ECDSA equation for an on-curve key and 1 <= r, s < n."""
    w = pow(s, -1, N)
    pt = _jac_to_affine(_jac_add(
        _mul_g_jac(e * w % N),
        _mul_window_jac(r * w % N, _WINDOWS.row((x, y)))))
    return pt is not None and pt[0] % N == r


def verify(public_xy: bytes, signature: bytes, digest: bytes) -> bool:
    """The software verdict with the provider's rules: 64-byte key on
    the curve (and not (0, 0)), 32-byte digest, strict DER, 1 <= r,s < n,
    low S, then the ECDSA equation."""
    if not isinstance(public_xy, (bytes, bytearray)) or len(public_xy) != 64:
        return False
    if not isinstance(digest, (bytes, bytearray)) or len(digest) != 32:
        return False
    try:
        r, s = decode_dss_signature(bytes(signature))
    except (ValueError, TypeError):
        return False
    if not (1 <= r < N and 1 <= s <= LOW_S_MAX):
        return False
    x = int.from_bytes(public_xy[:32], "big")
    y = int.from_bytes(public_xy[32:], "big")
    if not on_curve(x, y):
        return False
    return _equation_holds(x, y, r, s, int.from_bytes(digest, "big"))


def verify_certificate_signature(x: int, y: int, signature: bytes,
                                 message: bytes) -> bool:
    """ecdsa-with-SHA256 over `message` as X.509 uses it: no low-S rule
    (certificate issuers need not normalise s)."""
    try:
        r, s = decode_dss_signature(bytes(signature))
    except (ValueError, TypeError):
        return False
    if not (1 <= r < N and 1 <= s < N) or not on_curve(x, y):
        return False
    return _equation_holds(x, y, r, s,
                           int.from_bytes(hashlib.sha256(message).digest(),
                                          "big"))


def verify_item(item) -> bool:
    """`verify` for one VerifyItem; a raw-message item is hashed here."""
    digest = item.digest
    if item.message is not None:
        if not isinstance(item.message, (bytes, bytearray)):
            return False
        digest = hashlib.sha256(item.message).digest()
    return verify(item.public_xy, item.signature, digest)


# --- DER, PEM, SubjectPublicKeyInfo, PKCS#8 ---------------------------------
# The port's copy of fabric_mod_tpu/bccsp/_ecfallback.py's key encodings:
# what msp/ca.py mints and bccsp/x509.py parses.

def der_tlv(tag: int, body: bytes) -> bytes:
    """One DER TLV with a definite (short- or long-form) length."""
    n = len(body)
    if n < 0x80:
        return bytes([tag, n]) + body
    lb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([tag, 0x80 | len(lb)]) + lb + body


def der_seq(*parts: bytes) -> bytes:
    return der_tlv(0x30, b"".join(parts))


def der_int(v: int) -> bytes:
    if v < 0:
        raise ValueError("negative INTEGER")
    body = v.to_bytes((v.bit_length() + 7) // 8 or 1, "big")
    if body[0] & 0x80:
        body = b"\x00" + body
    return der_tlv(0x02, body)


def der_oid(dotted: str) -> bytes:
    arcs = [int(a) for a in dotted.split(".")]
    body = bytearray([arcs[0] * 40 + arcs[1]])
    for arc in arcs[2:]:
        chunk = [arc & 0x7F]
        arc >>= 7
        while arc:
            chunk.append(0x80 | (arc & 0x7F))
            arc >>= 7
        body.extend(reversed(chunk))
    return der_tlv(0x06, bytes(body))


class DerReader:
    """Strict walking reader over one DER blob."""

    def __init__(self, buf: bytes, start: int = 0, end: int = None):
        self.buf = buf
        self.off = start
        self.end = len(buf) if end is None else end

    def done(self) -> bool:
        return self.off >= self.end

    def peek_tag(self) -> int:
        if self.done():
            raise ValueError("truncated DER")
        return self.buf[self.off]

    def read(self, expect_tag: int = None):
        """-> (tag, value_start, value_end); advances past the TLV."""
        buf, off = self.buf, self.off
        if off + 2 > self.end:
            raise ValueError("truncated DER")
        tag = buf[off]
        if expect_tag is not None and tag != expect_tag:
            raise ValueError(
                f"DER tag 0x{tag:02x}, expected 0x{expect_tag:02x}")
        ln = buf[off + 1]
        off += 2
        if ln & 0x80:
            nb = ln & 0x7F
            if nb == 0 or nb > 4 or off + nb > self.end:
                raise ValueError("bad DER length")
            ln = int.from_bytes(buf[off:off + nb], "big")
            off += nb
        if off + ln > self.end:
            raise ValueError("DER value overruns buffer")
        self.off = off + ln
        return tag, off, off + ln

    def value(self, expect_tag: int = None) -> bytes:
        _, a, b = self.read(expect_tag)
        return self.buf[a:b]

    def reader(self, expect_tag: int = None) -> "DerReader":
        _, a, b = self.read(expect_tag)
        return DerReader(self.buf, a, b)


OID_EC_PUBLIC_KEY = "1.2.840.10045.2.1"
OID_PRIME256V1 = "1.2.840.10045.3.1.7"
OID_ECDSA_SHA256 = "1.2.840.10045.4.3.2"

_EC_ALG_ID = der_seq(der_oid(OID_EC_PUBLIC_KEY), der_oid(OID_PRIME256V1))


def pem_encode(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der)
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (b"-----BEGIN %s-----\n" % label.encode()
            + b"\n".join(lines)
            + b"\n-----END %s-----\n" % label.encode())


def pem_decode(data: bytes) -> bytes:
    """First PEM block -> DER bytes (label-agnostic: callers dispatch
    on content)."""
    lines = data.replace(b"\r", b"").split(b"\n")
    body, inside = [], False
    for ln in lines:
        if ln.startswith(b"-----BEGIN"):
            inside = True
            continue
        if ln.startswith(b"-----END"):
            break
        if inside:
            body.append(ln.strip())
    if not inside or not body:
        raise ValueError("no PEM block found")
    return base64.b64decode(b"".join(body))


def spki_der(x: int, y: int) -> bytes:
    """SubjectPublicKeyInfo DER for an uncompressed P-256 point."""
    point = b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return der_seq(_EC_ALG_ID, der_tlv(0x03, b"\x00" + point))


def parse_spki(der: bytes):
    """SubjectPublicKeyInfo DER -> the on-curve P-256 point (x, y)."""
    outer = DerReader(der).reader(0x30)
    alg = outer.reader(0x30)
    if alg.value(0x06) != der_oid(OID_EC_PUBLIC_KEY)[2:]:
        raise ValueError("non-EC SubjectPublicKeyInfo")
    if alg.value(0x06) != der_oid(OID_PRIME256V1)[2:]:
        raise ValueError("non-P256 SubjectPublicKeyInfo")
    bits = outer.value(0x03)
    if len(bits) != 66 or bits[0] != 0 or bits[1] != 0x04:
        raise ValueError("bad EC point BIT STRING")
    x = int.from_bytes(bits[2:34], "big")
    y = int.from_bytes(bits[34:], "big")
    if not on_curve(x, y):
        raise ValueError("point is not on P-256")
    return x, y


def pkcs8_der(key: PrivateKey) -> bytes:
    """PKCS#8 (unencrypted) DER embedding the RFC 5915 ECPrivateKey
    with the public point."""
    point = b"\x04" + key.public_xy()
    ecpriv = der_seq(
        der_int(1),
        der_tlv(0x04, key.d.to_bytes(32, "big")),
        der_tlv(0xA1, der_tlv(0x03, b"\x00" + point)))
    return der_seq(der_int(0), _EC_ALG_ID, der_tlv(0x04, ecpriv))


def parse_pkcs8(der: bytes) -> PrivateKey:
    outer = DerReader(der).reader(0x30)
    if outer.value(0x02) != b"\x00":
        raise ValueError("unsupported PKCS#8 version")
    alg = outer.reader(0x30)
    if alg.value(0x06) != der_oid(OID_EC_PUBLIC_KEY)[2:]:
        raise ValueError("non-EC private key")
    ecpriv = DerReader(outer.value(0x04)).reader(0x30)
    if ecpriv.value(0x02) != b"\x01":
        raise ValueError("unsupported ECPrivateKey version")
    return PrivateKey(int.from_bytes(ecpriv.value(0x04), "big"))


# --- the provider surface identities use ------------------------------------

class EcdsaKey:
    """A P-256 key handle (reference: bccsp/sw.py EcdsaKey): the public
    point and, for a signing key, the private scalar."""

    curve = "P256"

    def __init__(self, x: int, y: int, priv: PrivateKey = None):
        self.x, self.y = x, y
        self._priv = priv

    def public_xy(self) -> bytes:
        return self.x.to_bytes(32, "big") + self.y.to_bytes(32, "big")

    def ski(self) -> bytes:
        """SHA-256 over the uncompressed point, the reference's SKI."""
        return hashlib.sha256(b"\x04" + self.public_xy()).digest()

    def private(self) -> bool:
        return self._priv is not None


class SwCSP:
    """The software provider with the `SwCSP` surface that identities
    use (fabric_mod_tpu/bccsp/sw.py:179): PEM key import, SHA-256,
    sign and verify, all pure Python."""

    def key_import(self, raw: bytes, kind: str) -> EcdsaKey:
        if kind == "pem-pub":
            return EcdsaKey(*parse_spki(pem_decode(raw)))
        if kind == "pem-priv":
            priv = parse_pkcs8(pem_decode(raw))
            return EcdsaKey(*priv.public_point(), priv=priv)
        raise ValueError(f"unknown import kind {kind}")

    def hash(self, msg: bytes, algorithm: str = "SHA256") -> bytes:
        if algorithm != "SHA256":
            raise ValueError(f"unsupported hash {algorithm}")
        return hashlib.sha256(msg).digest()

    def sign(self, key: EcdsaKey, digest: bytes) -> bytes:
        if not key.private():
            raise ValueError("signing needs a private key")
        return key._priv.sign(digest)

    def verify(self, key: EcdsaKey, signature: bytes, digest: bytes) -> bool:
        return verify(key.public_xy(), signature, digest)


class SwVerifier:
    """A host verifier with GpuVerifier's `verify_many` surface over
    `verify_item`: the software oracle a block commit can run on in
    place of the card."""

    def verify_many(self, items) -> np.ndarray:
        return np.array([verify_item(it) for it in items], bool)
