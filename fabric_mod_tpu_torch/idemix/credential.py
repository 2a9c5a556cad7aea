"""Idemix anonymous credentials: issuance + presentation + Ver.

The port's copy of fabric_mod_tpu/idemix/credential.py.  Two changes:
`batch_verify` sends the pairing equations to the port's batched
pairing (ops/fp256bn_dev.py) on the card, and `IssuerKey`, `issue` and
`sign` take an optional `rng` (a random.Random) so a fixture builds the
same keys, credentials and presentations on any machine; without it
they draw from `secrets`, as the reference does.

(reference: idemix/ — issuerkey.go IssuerKey, credential.go
NewCredential/Ver, signature.go:50 NewSignature and :243
Signature.Ver — the BBS+-style scheme over FP256BN pairings.)

The scheme (multiplicative notation, G1/G2/GT from fp256bn):

  Issuer key:  isk = x;  ipk = (W = g2^x, HSk, HRand, HAttrs[0..L-1],
               all in G1, plus a Schnorr PoK of x)
  Credential:  on user secret sk and attributes a[0..L-1]:
               e, s random;  B = g1 * HSk^sk * HRand^s * prod Hi^ai
               A = B^(1/(e+x));   cred = (A, B, e, s)
               valid iff  e(A, W * g2^e) == e(B, g2)
  Presentation ("signature"): prove possession of a credential with
  the hidden attributes undisclosed and bind the proof to a message:
               r1, r2, r3=1/r1:  A' = A^r1 (never identity),
               Abar = A'^-e * B^r1,  B' = B^r1 * HRand^-r2,
               s' = s - r2*r3
               two Schnorr relations under Fiat-Shamir challenge c:
                 (1) Abar/B' = A'^-e * HRand^r2
                 (2) g1 * prod_{i in D} Hi^ai
                       = B'^r3 * HRand^-s' * HSk^-sk
                         * prod_{i not in D} Hi^-ai
  Ver (signature.go:243): ONE pairing equation
               e(A', W) == e(Abar, g2)
  plus the recomputed-challenge check of both Schnorr relations.

Keys/credentials here are self-consistent (sign/verify round-trips)
but not wire-compatible with amcl-issued material: the G2 generator is
our deterministic one (fp256bn.g2_generator), not the amcl ROM
constant, and the hash-to-group is SHA-256-based.
"""
from __future__ import annotations

import hashlib
import secrets
from typing import Dict, List, Optional, Sequence

from fabric_mod_tpu_torch.idemix import fp256bn as bn
from fabric_mod_tpu_torch.idemix.fp256bn import (
    G1, G2, Fp2, g1_add, g1_mul, g2_add, g2_mul, pairing)

R = bn.R


class IdemixError(Exception):
    pass


def _rand_zr(rng=None) -> int:
    """A uniform nonzero scalar: from `rng` when given, else `secrets`."""
    if rng is None:
        return secrets.randbelow(R - 1) + 1
    return rng.randrange(1, R)


def _nonce(rng=None) -> bytes:
    return secrets.token_bytes(32) if rng is None else rng.randbytes(32)


def _hash_to_zr(*parts: bytes) -> int:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(4, "big"))
        h.update(p)
    return int.from_bytes(h.digest(), "big") % R


def _g1_bytes(p: Optional[G1]) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p.x.to_bytes(32, "big") + p.y.to_bytes(32, "big")


def _g2_bytes(q: Optional[G2]) -> bytes:
    if q is None:
        return b"\x00" * 128
    return b"".join(v.to_bytes(32, "big")
                    for v in (q.x.a, q.x.b, q.y.a, q.y.b))


def hash_to_g1(label: bytes) -> G1:
    """Deterministic try-and-increment hash to the curve (cofactor 1
    on G1 for BN curves, so any curve point is in the r-group)."""
    ctr = 0
    while True:
        x = int.from_bytes(hashlib.sha256(
            b"fmt-idemix-h2c" + label + ctr.to_bytes(4, "big")
        ).digest(), "big") % bn.P
        rhs = (x * x * x + bn.B) % bn.P
        y = pow(rhs, (bn.P + 1) // 4, bn.P)
        if y * y % bn.P == rhs:
            return G1(x, y)
        ctr += 1


# --- Issuer key -------------------------------------------------------------

class IssuerKey:
    """(reference: idemix/issuerkey.go NewIssuerKey)"""

    def __init__(self, attr_names: Sequence[str], rng=None):
        self.attr_names = list(attr_names)
        self.x = _rand_zr(rng)
        self.g2 = bn.g2_generator()
        self.W = g2_mul(self.x, self.g2)
        self.HSk = hash_to_g1(b"HSk")
        self.HRand = hash_to_g1(b"HRand")
        self.HAttrs = [hash_to_g1(b"HAttr" + n.encode())
                       for n in self.attr_names]
        # PoK of x: t = g2^r, c = H(g2, W, t), z = r + c*x
        r = _rand_zr(rng)
        t = g2_mul(r, self.g2)
        self.pok_c = _hash_to_zr(_g2_bytes(self.g2), _g2_bytes(self.W),
                                 _g2_bytes(t))
        self.pok_z = (r + self.pok_c * self.x) % R

    def check_pok(self) -> bool:
        """Verify the issuer's proof of knowledge of x
        (reference: ipk.Check)."""
        t = g2_add(g2_mul(self.pok_z, self.g2),
                   g2_mul(-self.pok_c, self.W))
        return self.pok_c == _hash_to_zr(
            _g2_bytes(self.g2), _g2_bytes(self.W), _g2_bytes(t))

    # -- serialization (reference: the idemixgen artifact files) ---------
    def public_dict(self) -> dict:
        return {"attr_names": list(self.attr_names),
                "W": _g2_bytes(self.W).hex(),
                "pok_c": str(self.pok_c), "pok_z": str(self.pok_z)}

    def to_dict(self) -> dict:
        d = self.public_dict()
        d["x"] = str(self.x)               # the issuer SECRET key
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "IssuerKey":
        ik = cls.__new__(cls)
        ik.attr_names = list(d["attr_names"])
        # public-only artifacts have no secret: keep it None so
        # issuing with a public key fails LOUDLY, not with unverifiable
        # credentials
        ik.x = int(d["x"]) if "x" in d else None
        ik.g2 = bn.g2_generator()
        ik.W = _g2_from_hex(d["W"])
        ik.HSk = hash_to_g1(b"HSk")
        ik.HRand = hash_to_g1(b"HRand")
        ik.HAttrs = [hash_to_g1(b"HAttr" + n.encode())
                     for n in ik.attr_names]
        ik.pok_c = int(d["pok_c"])
        ik.pok_z = int(d["pok_z"])
        if not ik.check_pok():
            raise IdemixError("issuer key PoK invalid")
        return ik


# --- Credential -------------------------------------------------------------

def _g2_from_hex(hexs: str) -> Optional[G2]:
    raw = bytes.fromhex(hexs)
    if raw == b"\x00" * 128:
        return None
    vals = [int.from_bytes(raw[i:i + 32], "big") for i in range(0, 128, 32)]
    q = G2(Fp2(vals[0], vals[1]), Fp2(vals[2], vals[3]))
    if not q.is_on_curve():
        raise IdemixError("G2 point not on the twist")
    return q


def _g1_from_hex(hexs: str) -> Optional[G1]:
    raw = bytes.fromhex(hexs)
    if raw == b"\x00" * 64:
        return None
    p = G1(int.from_bytes(raw[:32], "big"),
           int.from_bytes(raw[32:], "big"))
    if not p.is_on_curve():
        raise IdemixError("G1 point not on the curve")
    return p


class Credential:
    def __init__(self, A: G1, B: G1, e: int, s: int,
                 attrs: List[int]):
        self.A, self.B, self.e, self.s = A, B, e, s
        self.attrs = list(attrs)

    def to_dict(self) -> dict:
        return {"A": _g1_bytes(self.A).hex(), "B": _g1_bytes(self.B).hex(),
                "e": str(self.e), "s": str(self.s),
                "attrs": [str(a) for a in self.attrs]}

    @classmethod
    def from_dict(cls, d: dict) -> "Credential":
        return cls(_g1_from_hex(d["A"]), _g1_from_hex(d["B"]),
                   int(d["e"]), int(d["s"]),
                   [int(a) for a in d["attrs"]])


def issue(ik: IssuerKey, sk: int, attrs: Sequence[int],
          rng=None) -> Credential:
    """(reference: idemix/credential.go NewCredential — collapsed
    issuance: the blinded-request round trip is protocol plumbing)"""
    if len(attrs) != len(ik.HAttrs):
        raise IdemixError("attribute count mismatch")
    if ik.x is None:
        raise IdemixError("issuer key is public-only; issuing needs "
                          "the secret key")
    e, s = _rand_zr(rng), _rand_zr(rng)
    B = g1_add(G1.generator(), g1_mul(sk, ik.HSk))
    B = g1_add(B, g1_mul(s, ik.HRand))
    for ai, Hi in zip(attrs, ik.HAttrs):
        B = g1_add(B, g1_mul(ai, Hi))
    inv = pow((e + ik.x) % R, -1, R)
    A = g1_mul(inv, B)
    return Credential(A, B, e, s, list(attrs))


def credential_valid(ik: IssuerKey, cred: Credential) -> bool:
    """e(A, W * g2^e) == e(B, g2) (reference: credential.go Ver)"""
    lhs = pairing(cred.A, g2_add(ik.W, g2_mul(cred.e, ik.g2)))
    rhs = pairing(cred.B, ik.g2)
    return lhs == rhs


# --- Presentation signature -------------------------------------------------

class Signature:
    __slots__ = ("A_prime", "A_bar", "B_prime", "c", "z_e", "z_r2",
                 "z_r3", "z_s", "z_sk", "z_attrs", "nonce")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def sign(ik: IssuerKey, cred: Credential, sk: int, msg: bytes,
         disclosed: Dict[int, int], rng=None) -> Signature:
    """Create a presentation proof over `msg` disclosing only the
    attribute indices in `disclosed` (reference: signature.go:50
    NewSignature)."""
    for i, v in disclosed.items():
        if cred.attrs[i] != v:
            raise IdemixError("disclosed value mismatch")
    r1 = _rand_zr(rng)
    r2 = _rand_zr(rng)
    r3 = pow(r1, -1, R)
    A_prime = g1_mul(r1, cred.A)
    A_bar = g1_add(g1_mul((-cred.e) % R, A_prime),
                   g1_mul(r1, cred.B))
    B_prime = g1_add(g1_mul(r1, cred.B), g1_mul((-r2) % R, ik.HRand))
    s_prime = (cred.s - r2 * r3) % R
    hidden = [i for i in range(len(cred.attrs)) if i not in disclosed]

    # commitments
    re_, rr2 = _rand_zr(rng), _rand_zr(rng)
    rr3, rs = _rand_zr(rng), _rand_zr(rng)
    rsk = _rand_zr(rng)
    rattrs = {i: _rand_zr(rng) for i in hidden}
    t1 = g1_add(g1_mul(re_, A_prime), g1_mul(rr2, ik.HRand))
    t2 = g1_add(g1_mul(rr3, B_prime), g1_mul((-rs) % R, ik.HRand))
    t2 = g1_add(t2, g1_mul((-rsk) % R, ik.HSk))
    for i in hidden:
        t2 = g1_add(t2, g1_mul((-rattrs[i]) % R, ik.HAttrs[i]))

    nonce = _nonce(rng)
    c = _challenge(ik, A_prime, A_bar, B_prime, t1, t2, disclosed,
                   msg, nonce)
    return Signature(
        A_prime=A_prime, A_bar=A_bar, B_prime=B_prime, c=c,
        z_e=(re_ + c * ((-cred.e) % R)) % R,
        z_r2=(rr2 + c * r2) % R,
        z_r3=(rr3 + c * r3) % R,
        z_s=(rs + c * s_prime) % R,
        z_sk=(rsk + c * sk) % R,
        z_attrs={i: (rattrs[i] + c * cred.attrs[i]) % R for i in hidden},
        nonce=nonce)


def _challenge(ik, A_prime, A_bar, B_prime, t1, t2, disclosed, msg,
               nonce) -> int:
    parts = [_g1_bytes(A_prime), _g1_bytes(A_bar), _g1_bytes(B_prime),
             _g1_bytes(t1), _g1_bytes(t2), _g2_bytes(ik.W), msg, nonce]
    for i in sorted(disclosed):
        parts.append(i.to_bytes(4, "big"))
        parts.append(disclosed[i].to_bytes(32, "big"))
    return _hash_to_zr(*parts)


def verify(ik: IssuerKey, sig: Signature, msg: bytes,
           disclosed: Dict[int, int]) -> bool:
    """(reference: idemix/signature.go:243 Signature.Ver — the
    pairing check + recomputed Fiat-Shamir challenge)"""
    if sig.A_prime is None:
        return False                   # A' must not be the identity
    # THE pairing equation: e(A', W) == e(Abar, g2)
    if pairing(sig.A_prime, ik.W) != pairing(sig.A_bar, ik.g2):
        return False
    return _verify_schnorr(ik, sig, msg, disclosed)


def batch_verify(ik: IssuerKey, items, use_device: bool = True,
                 device=None):
    """Verify many presentations at once: the pairing equations — the
    ~85% cost of Ver — run as ONE batched pairing check
    (ops/fp256bn_dev.pairing_check_batch, on the card unless `device`
    says otherwise); the Schnorr/Fiat-Shamir algebra stays host-side.
    `use_device=False` is the explicit host path (host pairings).

    `items`: [(sig, msg, disclosed)];  -> [bool] per item.
    (reference behavior anchor: idemix/signature.go:243 Ver, applied
    per block of presentations — BASELINE config #4)."""
    results = [False] * len(items)
    todo = []                          # (index, sig)
    for idx, (sig, _msg, _d) in enumerate(items):
        if sig.A_prime is not None and sig.A_bar is not None:
            todo.append(idx)
    if todo:
        if use_device:
            from fabric_mod_tpu_torch.ops.fp256bn_dev import (
                pairing_check_batch)
            a_pts = [items[i][0].A_prime for i in todo]
            b_pts = [items[i][0].A_bar.neg() for i in todo]
            ok = pairing_check_batch(a_pts, ik.W, b_pts, ik.g2,
                                     device=device)
            pair_ok = {i: bool(o) for i, o in zip(todo, ok)}
        else:
            pair_ok = {i: pairing(items[i][0].A_prime, ik.W) ==
                       pairing(items[i][0].A_bar, ik.g2) for i in todo}
        for i in todo:
            if pair_ok[i]:
                sig, msg, disclosed = items[i]
                results[i] = _verify_schnorr(ik, sig, msg, disclosed)
    return results


def _verify_schnorr(ik: IssuerKey, sig: Signature, msg: bytes,
                    disclosed: Dict[int, int]) -> bool:
    """The non-pairing remainder of Ver: recompute the Fiat-Shamir
    commitments from the responses and check the challenge."""
    c = sig.c
    # t1' = A'^z_e * HRand^z_r2 * (Abar/B')^-c
    t1 = g1_add(g1_mul(sig.z_e, sig.A_prime),
                g1_mul(sig.z_r2, ik.HRand))
    abar_over_bp = g1_add(sig.A_bar, sig.B_prime.neg()
                          if sig.B_prime else None)
    t1 = g1_add(t1, g1_mul((-c) % R, abar_over_bp))
    # t2' = B'^z_r3 * HRand^-z_s * HSk^-z_sk * prod_hidden Hi^-z_ai
    #       * (g1 * prod_disclosed Hi^ai)^-c
    t2 = g1_add(g1_mul(sig.z_r3, sig.B_prime),
                g1_mul((-sig.z_s) % R, ik.HRand))
    t2 = g1_add(t2, g1_mul((-sig.z_sk) % R, ik.HSk))
    for i, z in sig.z_attrs.items():
        if i in disclosed:
            return False               # hidden/disclosed sets must agree
        t2 = g1_add(t2, g1_mul((-z) % R, ik.HAttrs[i]))
    base = G1.generator()
    for i in sorted(disclosed):
        base = g1_add(base, g1_mul(disclosed[i], ik.HAttrs[i]))
    t2 = g1_add(t2, g1_mul((-c) % R, base))
    if set(sig.z_attrs) | set(disclosed) != set(range(len(ik.HAttrs))):
        return False
    return c == _challenge(ik, sig.A_prime, sig.A_bar, sig.B_prime,
                           t1, t2, disclosed, msg, sig.nonce)
