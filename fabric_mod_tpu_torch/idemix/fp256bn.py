"""FP256BN pairing arithmetic — host-side reference implementation.

The port's copy of fabric_mod_tpu/idemix/fp256bn.py, kept pure Python
and unchanged in its arithmetic: it is the oracle the batched pairing
of ops/fp256bn_dev.py is held against on the card.

(reference: the fabric-amcl FP256BN library behind idemix/ —
idemix/util.go:13-21 — re-derived from the public curve definition:
FP256BN is the ISO/IEC 15946-5 / CFRG "BN256" curve with BN parameter
u = -0x6882F5C030B0A801, p = 36u⁴+36u³+24u²+6u+1,
r = 36u⁴+36u³+18u²+6u+1, E: y² = x³ + 3 over Fp, G1 = (1, 2), and a
sextic twist over Fp2 with ξ = 1 + i.)

A correct, slow optimal-ate pairing: generic Fp12 line evaluation in
the Miller loop and a naive square-and-multiply hard part in the final
exponentiation.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

# --- BN parameters ----------------------------------------------------------
U = -0x6882F5C030B0A801
P = 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1
R = 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1
T = 6 * U**2 + 1                     # trace of Frobenius
B = 3                                # E: y^2 = x^3 + 3

assert P % 4 == 3                    # i^2 = -1 is a non-residue


def _inv(a: int, m: int = P) -> int:
    return pow(a, -1, m)


# --- Fp2 = Fp[i]/(i^2+1) ----------------------------------------------------

class Fp2:
    __slots__ = ("a", "b")           # a + b*i

    def __init__(self, a: int, b: int = 0):
        self.a = a % P
        self.b = b % P

    def __add__(self, o):  return Fp2(self.a + o.a, self.b + o.b)
    def __sub__(self, o):  return Fp2(self.a - o.a, self.b - o.b)
    def __neg__(self):     return Fp2(-self.a, -self.b)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp2(self.a * o, self.b * o)
        # Karatsuba
        t0 = self.a * o.a
        t1 = self.b * o.b
        t2 = (self.a + self.b) * (o.a + o.b)
        return Fp2(t0 - t1, t2 - t0 - t1)

    __rmul__ = __mul__

    def sqr(self):
        # (a+bi)^2 = (a+b)(a-b) + 2ab i
        return Fp2((self.a + self.b) * (self.a - self.b),
                   2 * self.a * self.b)

    def inv(self):
        d = _inv((self.a * self.a + self.b * self.b) % P)
        return Fp2(self.a * d, -self.b * d)

    def conj(self):
        return Fp2(self.a, -self.b)

    def mul_xi(self):
        """Multiply by xi = 1 + i (the twist constant)."""
        return Fp2(self.a - self.b, self.a + self.b)

    def __eq__(self, o):
        return self.a == o.a and self.b == o.b

    def is_zero(self):
        return self.a == 0 and self.b == 0

    def __repr__(self):
        return f"Fp2({hex(self.a)},{hex(self.b)})"

    @staticmethod
    def zero():
        return Fp2(0, 0)

    @staticmethod
    def one():
        return Fp2(1, 0)


XI = Fp2(1, 1)
# The sextic twist carrying the r-torsion for this (p, xi) is the
# M-type: y^2 = x^3 + 3*xi (verified empirically in tests: cofactor
# (2p - r) clearing yields r-torsion on 3*xi, not on 3/xi).
B_TWIST = XI * B


# --- Fp6 = Fp2[v]/(v^3 - xi);  Fp12 = Fp6[w]/(w^2 - v) ----------------------

class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero():
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one():
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        if isinstance(o, (int, Fp2)):
            return Fp6(self.c0 * o, self.c1 * o, self.c2 * o)
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_xi() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_xi()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def sqr(self):
        return self * self

    def mul_v(self):
        """Multiply by v (the Fp6 indeterminate)."""
        return Fp6(self.c2.mul_xi(), self.c0, self.c1)

    def inv(self):
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.sqr() - (a1 * a2).mul_xi()
        t1 = a2.sqr().mul_xi() - a0 * a1
        t2 = a1.sqr() - a0 * a2
        d = (a0 * t0 + (a2 * t1).mul_xi() + (a1 * t2).mul_xi())
        di = Fp2(d.a, d.b).inv() if d.b else Fp2(_inv(d.a), 0)
        return Fp6(t0 * di, t1 * di, t2 * di)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1 and self.c2 == o.c2

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()


class Fp12:
    __slots__ = ("c0", "c1")         # c0 + c1*w

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one():
        return Fp12(Fp6.one(), Fp6.zero())

    def __add__(self, o):
        return Fp12(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp12(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp12(-self.c0, -self.c1)

    def __mul__(self, o):
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(t0 + t1.mul_v(),
                    (a0 + a1) * (b0 + b1) - t0 - t1)

    def sqr(self):
        a0, a1 = self.c0, self.c1
        t0 = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_v()) - t0 - t0.mul_v()
        return Fp12(c0, t0 + t0)

    def conj(self):
        """Conjugate over Fp6 (the p^6 Frobenius): unary inverse for
        elements in the cyclotomic subgroup."""
        return Fp12(self.c0, -self.c1)

    def inv(self):
        t = (self.c0 * self.c0 - (self.c1 * self.c1).mul_v()).inv()
        return Fp12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int):
        if e < 0:
            return self.pow(-e).inv()
        acc = Fp12.one()
        base = self
        while e:
            if e & 1:
                acc = acc * base
            base = base.sqr()
            e >>= 1
        return acc

    def frobenius(self):
        """x -> x^p."""
        c0, c1 = self.c0, self.c1
        f0 = Fp6(c0.c0.conj(), c0.c1.conj() * _FROB6_1,
                 c0.c2.conj() * _FROB6_2)
        f1 = Fp6(c1.c0.conj() * _FROB12, c1.c1.conj() * _FROB12 * _FROB6_1,
                 c1.c2.conj() * _FROB12 * _FROB6_2)
        return Fp12(f0, f1)

    def __eq__(self, o):
        return self.c0 == o.c0 and self.c1 == o.c1


def _fp2_pow(x: Fp2, e: int) -> Fp2:
    acc = Fp2.one()
    while e:
        if e & 1:
            acc = acc * x
        x = x.sqr()
        e >>= 1
    return acc


# Frobenius constants: gamma = xi^((p-1)/6); v^p = gamma^2 v-ish.
# v^p = v^(p-1) * v = xi^((p-1)/3) * v ; w^p = xi^((p-1)/6) * w.
_FROB6_1 = _fp2_pow(XI, (P - 1) // 3)     # multiplies c1 of Fp6
_FROB6_2 = _fp2_pow(XI, 2 * (P - 1) // 3)  # multiplies c2 of Fp6
_FROB12 = _fp2_pow(XI, (P - 1) // 6)       # multiplies the w part


# --- Curve points -----------------------------------------------------------

class G1:
    """Affine point on E/Fp: y^2 = x^3 + 3 (None = infinity)."""

    __slots__ = ("x", "y")

    def __init__(self, x: int, y: int):
        self.x, self.y = x % P, y % P

    @staticmethod
    def generator():
        return G1(1, 2)

    def is_on_curve(self) -> bool:
        return (self.y * self.y - self.x**3 - B) % P == 0

    def __eq__(self, o):
        if o is None:
            return False
        return self.x == o.x and self.y == o.y

    def neg(self):
        return G1(self.x, -self.y)


def g1_add(p: Optional[G1], q: Optional[G1]) -> Optional[G1]:
    if p is None:
        return q
    if q is None:
        return p
    if p.x == q.x and (p.y + q.y) % P == 0:
        return None
    if p.x == q.x:
        lam = (3 * p.x * p.x) * _inv(2 * p.y) % P
    else:
        lam = (q.y - p.y) * _inv(q.x - p.x) % P
    x3 = (lam * lam - p.x - q.x) % P
    return G1(x3, lam * (p.x - x3) - p.y)


def g1_mul(k: int, p: Optional[G1]) -> Optional[G1]:
    if k < 0:
        return g1_mul(-k, p.neg() if p else None)
    acc = None
    while k:
        if k & 1:
            acc = g1_add(acc, p)
        p = g1_add(p, p)
        k >>= 1
    return acc


class G2:
    """Affine point on the twist E'/Fp2: y^2 = x^3 + 3/xi."""

    __slots__ = ("x", "y")

    def __init__(self, x: Fp2, y: Fp2):
        self.x, self.y = x, y

    def is_on_curve(self) -> bool:
        return self.y.sqr() == self.x.sqr() * self.x + B_TWIST

    def __eq__(self, o):
        if o is None:
            return False
        return self.x == o.x and self.y == o.y

    def neg(self):
        return G2(self.x, -self.y)


def g2_add(p: Optional[G2], q: Optional[G2]) -> Optional[G2]:
    if p is None:
        return q
    if q is None:
        return p
    if p.x == q.x and (p.y + q.y).is_zero():
        return None
    if p.x == q.x:
        lam = (p.x.sqr() * 3) * (p.y * 2).inv()
    else:
        lam = (q.y - p.y) * (q.x - p.x).inv()
    x3 = lam.sqr() - p.x - q.x
    return G2(x3, lam * (p.x - x3) - p.y)


def g2_mul(k: int, p: Optional[G2]) -> Optional[G2]:
    if k < 0:
        return g2_mul(-k, p.neg() if p else None)
    acc = None
    while k:
        if k & 1:
            acc = g2_add(acc, p)
        p = g2_add(p, p)
        k >>= 1
    return acc


def _g2_cofactor() -> int:
    # #E'(Fp2) = p^2 - 1 + t^2  hmm — standard: n2 = p + t - 1 reduced…
    # For BN curves the twist order is h2 * r with h2 = p - 1 + t.
    return P - 1 + T


def g2_generator() -> G2:
    """A fixed generator of the r-torsion on the twist: hash-free
    deterministic construction — smallest valid x, cofactor-cleared.

    NOTE: this is OUR generator, not fabric-amcl's ROM constant; all
    keys/credentials here are self-consistent but not wire-compatible
    with amcl-issued ones until the ROM generator is transcribed."""
    x = Fp2(0, 1)
    while True:
        rhs = x.sqr() * x + B_TWIST
        y = _fp2_sqrt(rhs)
        if y is not None:
            cand = G2(x, y)
            gen = g2_mul(_g2_cofactor(), cand)
            if gen is not None:
                assert g2_mul(R, gen) is None, "twist generator not r-torsion"
                return gen
        x = x + Fp2.one()


def _fp2_sqrt(a: Fp2) -> Optional[Fp2]:
    """Square root in Fp2 (p = 3 mod 4), via the norm trick."""
    if a.is_zero():
        return Fp2.zero()
    # norm = a.a^2 + a.b^2 must be a QR in Fp
    n = (a.a * a.a + a.b * a.b) % P
    s = pow(n, (P + 1) // 4, P)
    if s * s % P != n:
        return None
    # x = sqrt((a.a + s)/2) (try both signs of s)
    for sv in (s, P - s):
        half = (a.a + sv) * _inv(2) % P
        x = pow(half, (P + 1) // 4, P)
        if x * x % P != half:
            continue
        if x == 0:
            continue
        y = a.b * _inv(2 * x) % P
        cand = Fp2(x, y)
        if cand.sqr() == a:
            return cand
    return None


# --- Untwist: E'(Fp2) -> E(Fp12) -------------------------------------------
# M-type twist iso with u = w^-1 (u^6 = 1/xi):
#   psi(x', y') = (x' * v^2 / xi,  y' * v*w / xi)
# (v^3 = xi, w^2 = v; verified on-curve + group-iso in tests).

def untwist(q: Optional[G2]):
    """Twist point -> (X, Y) in full Fp12 coordinates on y^2=x^3+3."""
    if q is None:
        return None
    xi_inv = XI.inv()
    x = Fp12(Fp6(Fp2.zero(), Fp2.zero(), q.x * xi_inv), Fp6.zero())
    y = Fp12(Fp6.zero(), Fp6(Fp2.zero(), q.y * xi_inv, Fp2.zero()))
    return (x, y)


def _twist_down(X: Fp12, Y: Fp12) -> G2:
    """Inverse of `untwist` for sparse images (used by the Frobenius
    endomorphism on G2)."""
    return G2(X.c0.c2 * XI, Y.c1.c1 * XI)


def g2_frobenius(q: G2) -> G2:
    """The p-power Frobenius endomorphism on G2 (untwist-Frobenius-
    twist): psi^-1 . pi_p . psi — sparse shapes are preserved, so this
    is just conjugation + two Fp2 constants."""
    X, Y = untwist(q)
    return _twist_down(X.frobenius(), Y.frobenius())


# --- Optimal ate pairing ----------------------------------------------------

def _fp12_of(n: int) -> Fp12:
    return Fp12(Fp6(Fp2(n), Fp2.zero(), Fp2.zero()), Fp6.zero())


def _line(q1: G2, q2: G2, p: G1) -> Tuple[Fp12, Optional[G2]]:
    """Line through q1, q2 (tangent when equal) evaluated at the G1
    point p, computed in full Fp12 via the untwist (generic, not
    sparse-packed: this is the correctness spike; the kernel plan
    sparsifies).  Returns (l(P), q1+q2)."""
    X1, Y1 = untwist(q1)
    xP, yP = _fp12_of(p.x), _fp12_of(p.y)
    if q1.x == q2.x and (q1.y + q2.y).is_zero():
        return xP - X1, None
    if q1 == q2:
        lam2 = (q1.x.sqr() * 3) * (q1.y * 2).inv()
    else:
        lam2 = (q2.y - q1.y) * (q2.x - q1.x).inv()
    x3 = lam2.sqr() - q1.x - q2.x
    q3 = G2(x3, lam2 * (q1.x - x3) - q1.y)
    # lambda in Fp12 via the untwist scaling: lam12 = lam' * u with
    # u = w^-1... easier: recompute from untwisted endpoints
    X2, Y2 = untwist(q2)
    if q1 == q2:
        lam12 = (X1 * X1 * _fp12_of(3)) * (Y1 + Y1).inv()
    else:
        lam12 = (Y2 - Y1) * (X2 - X1).inv()
    l = yP - Y1 - lam12 * (xP - X1)
    return l, q3


def miller_loop(p: G1, q: G2) -> Fp12:
    """Miller loop for the optimal ate pairing: f_{6u+2,Q}(P) times the
    two Frobenius line corrections (6u+2 < 0 here, so the loop result
    is conjugated and T negated, Aranha et al.'s standard trick)."""
    e = 6 * U + 2
    neg = e < 0
    e = abs(e)
    bits = bin(e)[3:]                 # skip leading 1
    f = Fp12.one()
    t = q
    for bit in bits:
        l, t = _line(t, t, p)
        f = f.sqr() * l
        if bit == "1":
            l, t = _line(t, q, p)
            f = f * l
    if neg:
        f = f.conj()                 # f_{-n} = 1/f_n after final exp
        t = t.neg()
    # Frobenius corrections: Q1 = pi_p(Q), Q2 = -pi_p^2(Q)
    q1 = g2_frobenius(q)
    q2 = g2_frobenius(q1).neg()
    l, t = _line(t, q1, p)
    f = f * l
    l, _ = _line(t, q2, p)
    f = f * l
    return f


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12-1)/r): easy part then (slow, correct) hard part."""
    # easy: f^(p^6-1) = conj(f)/f ; then ^(p^2+1)
    f = f.conj() * f.inv()
    f = f.frobenius().frobenius() * f
    # hard part (p^4 - p^2 + 1)/r — naive square-and-multiply (spike)
    e = (P**4 - P**2 + 1) // R
    return f.pow(e)


def pairing(p: Optional[G1], q: Optional[G2]) -> Fp12:
    if p is None or q is None:
        return Fp12.one()
    return final_exponentiation(miller_loop(p, q))
