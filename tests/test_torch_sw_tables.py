"""The port's software P-256 tables (bccsp/sw.py): G's 8-bit comb, the
per-key 4-bit comb a public key is promoted to after repeated verifies,
and the window table before it, against the reference fallback's
double-and-add (fabric_mod_tpu/bccsp/_ecfallback.py `point_mul`)."""
import hashlib
import random

import pytest

from fabric_mod_tpu.bccsp import _ecfallback as ref
from fabric_mod_tpu_torch.bccsp import sw

EDGE = [1, 2, 15, 16, 17, 255, 256, 257, (1 << 64) - 1, (1 << 64) + 1,
        1 << 255, sw.N - 2, sw.N - 1]


def _scalars(seed: int, n: int) -> list:
    rng = random.Random(seed)
    return EDGE + [rng.randrange(1, sw.N) for _ in range(n)]


def _key_point(seed: int):
    return ref.point_mul(0x5EED + 7919 * seed, (ref.GX, ref.GY))


@pytest.mark.parametrize("seed", range(3))
def test_g_comb_equals_reference(seed):
    for k in _scalars(seed, 30):
        got = sw._jac_to_affine(sw._mul_g_jac(k))
        assert got == ref.point_mul(k, (ref.GX, ref.GY)), k


@pytest.mark.parametrize("seed", range(3))
def test_key_comb_equals_reference(seed):
    q = _key_point(seed)
    rows = sw._comb_rows(q, sw._KeyTables.BITS)
    assert len(rows) == 64 and {len(r) for r in rows} == {15}
    for k in _scalars(seed + 10, 30):
        got = sw._jac_to_affine(sw._mul_comb_jac(k, rows,
                                                 sw._KeyTables.BITS))
        assert got == ref.point_mul(k, q), k


def test_promotion_keeps_every_product():
    """The window table serves a key's first uses, the comb the rest;
    every product equals the reference's either way."""
    tables = sw._KeyTables(comb_after=4)
    q = _key_point(9)
    for i, k in enumerate(_scalars(11, 6)):
        assert sw._jac_to_affine(tables.mul(k, q)) == ref.point_mul(k, q)
        assert (q in tables._combs) == (i >= 3)
    assert q in tables._combs and q not in tables._rows


def test_caps_bound_the_tables():
    tables = sw._KeyTables(cap=2, comb_cap=1, comb_after=2)
    points = [_key_point(20 + i) for i in range(3)]
    for q in points:
        for k in (3, 5):
            assert sw._jac_to_affine(tables.mul(k, q)) == \
                ref.point_mul(k, q)
    assert len(tables._combs) <= 1 and len(tables._rows) <= 2


def test_verdicts_across_promotion():
    """One key verifies past its promotion: valid signatures hold,
    tampered digests and signatures fail, and each verdict equals the
    ECDSA equation recomputed with the reference's arithmetic."""
    key = sw.PrivateKey.from_seed(b"sw-tables")
    pub = key.public_xy()
    q = key.public_point()
    for i in range(2 * sw._KEYS.comb_after + 2):
        d = hashlib.sha256(b"msg%d" % i).digest()
        sig = key.sign(d)
        r, s = sw.decode_dss_signature(sig)
        w = pow(s, -1, sw.N)
        e = int.from_bytes(d, "big")
        pt = ref.point_add(ref.point_mul(e * w % sw.N, (ref.GX, ref.GY)),
                           ref.point_mul(r * w % sw.N, q))
        assert pt is not None and pt[0] % sw.N == r
        assert sw.verify(pub, sig, d)
        assert not sw.verify(pub, sig, bytes([d[0] ^ 1]) + d[1:])
        bad = sw.encode_dss_signature(r, (s + 1) % sw.N or 1)
        assert not sw.verify(pub, bad, d)
    assert q in sw._KEYS._combs
