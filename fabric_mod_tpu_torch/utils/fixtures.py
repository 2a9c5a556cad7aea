"""Signature fixtures — real P-256 signatures from seeds, with the
expected verdict mask.

The port's copy of fabric_mod_tpu/utils/fixtures.py's verify fixtures
(`make_verify_items`, `signature_arrays`), plus `make_block`: the
signature traffic of one committed block — 1000 transactions under a
2-of-3 endorsement policy (the txvalidator configuration of BASELINE.md
#2), so 1000 creator + 2000 endorser signatures.  Everything is made by
the pure-python signer (bccsp/sw.py) from a seed: no `cryptography`
wheel and no randomness outside the seed.
"""
from __future__ import annotations

import hashlib
import random
from typing import List, Optional, Tuple

import numpy as np

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.bccsp.api import VerifyItem


def _keys(seed: bytes, label: bytes, n: int) -> List[sw.PrivateKey]:
    return [sw.PrivateKey.from_seed(seed + b"|" + label + b"|%d" % i)
            for i in range(n)]


def make_verify_items(
        n: int, n_keys: int = 8, invalid_every: Optional[int] = None,
        seed: bytes = b"fixture") -> Tuple[List[VerifyItem], List[bool]]:
    """n signed VerifyItems over `n_keys` keys; every `invalid_every`-th
    item (i % invalid_every == invalid_every - 1) gets a tampered
    digest.  Signatures are low-S, like production signing."""
    keys = _keys(seed, b"key", min(n_keys, max(n, 1)))
    items, expect = [], []
    for i in range(n):
        k = keys[i % len(keys)]
        digest = hashlib.sha256(seed + b"-%d" % i).digest()
        sig = k.sign(digest)
        bad = invalid_every is not None and i % invalid_every == invalid_every - 1
        if bad:
            digest = hashlib.sha256(seed + b"-tampered-%d" % i).digest()
        items.append(VerifyItem(digest, sig, k.public_xy()))
        expect.append(not bad)
    return items, expect


def signature_arrays(
        n: int, tamper_last: bool = True,
        seed: bytes = b"fixture") -> Tuple[np.ndarray, ...]:
    """The same fixtures as (n, 32) uint8 arrays (digest, r, s, qx, qy)
    plus the expected mask — the shape ops/p256.marshal_inputs takes."""
    items, _ = make_verify_items(n, n_keys=1, seed=seed)
    d = np.zeros((n, 32), np.uint8)
    r = np.zeros((n, 32), np.uint8)
    s = np.zeros((n, 32), np.uint8)
    qx = np.zeros((n, 32), np.uint8)
    qy = np.zeros((n, 32), np.uint8)
    expect = np.ones(n, bool)
    for i, it in enumerate(items):
        ri, si = sw.decode_dss_signature(it.signature)
        d[i] = np.frombuffer(it.digest, np.uint8)
        r[i] = np.frombuffer(ri.to_bytes(32, "big"), np.uint8)
        s[i] = np.frombuffer(si.to_bytes(32, "big"), np.uint8)
        qx[i] = np.frombuffer(it.public_xy[:32], np.uint8)
        qy[i] = np.frombuffer(it.public_xy[32:], np.uint8)
    if tamper_last and n:
        d[n - 1, 0] ^= 0xFF
        expect[n - 1] = False
    return d, r, s, qx, qy, expect


ORGS = (b"Org1", b"Org2", b"Org3")


def make_block(block_no: int, n_tx: int = 1000, n_clients: int = 64,
               raw_endorsers: bool = False, adversarial: bool = True,
               seed: bytes = b"block") -> Tuple[List[VerifyItem], np.ndarray]:
    """The signature items of one block and its expected verdict mask.

    Each transaction carries a creator signature (one of `n_clients`
    client keys, spread round-robin) over its 200-2000 byte payload and
    two endorser signatures (2 of the 3 org peers, chosen per tx) over
    their proposal-response bytes — 3 items per tx, all distinct.  With
    `raw_endorsers` the endorser items carry the raw message (hashed on
    the device); otherwise every item carries its SHA-256 digest.

    With `adversarial`, the lanes of the reference bench's differential
    (bench.py measure_diffverify) are planted every 97 items: tampered
    digest/message, wrong key, s = 0, r = n, off-curve key, key (0, 0),
    high-S mirror — each expected False."""
    rng = random.Random(hashlib.sha256(seed + b"|%d" % block_no).digest())
    clients = _keys(seed, b"client", n_clients)
    peers = _keys(seed, b"peer", len(ORGS))
    items: List[VerifyItem] = []
    keys: List[sw.PrivateKey] = []
    for j in range(n_tx):
        payload = (b"blk%d-tx%d|" % (block_no, j)
                   + rng.randbytes(rng.randrange(200, 2001)))
        creator = clients[(block_no * n_tx + j) % n_clients]
        items.append(VerifyItem(hashlib.sha256(payload).digest(),
                                creator.sign(hashlib.sha256(payload).digest()),
                                creator.public_xy()))
        keys.append(creator)
        for org in sorted(rng.sample(range(len(ORGS)), 2)):
            prp = (b"prp|" + ORGS[org] + b"|%d|%d|" % (block_no, j)
                   + rng.randbytes(rng.randrange(200, 2001)))
            digest = hashlib.sha256(prp).digest()
            sig = peers[org].sign(digest)
            if raw_endorsers:
                items.append(VerifyItem(b"", sig, peers[org].public_xy(), prp))
            else:
                items.append(VerifyItem(digest, sig, peers[org].public_xy()))
            keys.append(peers[org])
    expect = np.ones(len(items), bool)
    if adversarial:
        _plant_adversarial(items, keys, expect)
    return items, expect


def _replace(it: VerifyItem, **kw) -> VerifyItem:
    fields = dict(digest=it.digest, signature=it.signature,
                  public_xy=it.public_xy, message=it.message)
    fields.update(kw)
    return VerifyItem(**fields)


def _plant_adversarial(items, keys, expect) -> None:
    n = len(items)
    for base in range(0, n - 8, 97):
        it = items[base]
        if it.message is not None:
            m = bytearray(it.message)
            m[0] ^= 1
            items[base] = _replace(it, message=bytes(m))
        else:
            d = bytearray(it.digest)
            d[0] ^= 1
            items[base] = _replace(it, digest=bytes(d))
        own = items[base + 1].public_xy
        other = next(k.public_xy() for k in keys[base + 2:] + keys[:base]
                     if k.public_xy() != own)
        items[base + 1] = _replace(items[base + 1], public_xy=other)
        r, s = sw.decode_dss_signature(items[base + 3].signature)
        items[base + 3] = _replace(items[base + 3],
                                   signature=sw.encode_dss_signature(r, 0))
        r, s = sw.decode_dss_signature(items[base + 4].signature)
        items[base + 4] = _replace(items[base + 4],
                                   signature=sw.encode_dss_signature(sw.N, s))
        xy = bytearray(items[base + 5].public_xy)
        xy[63] ^= 1
        items[base + 5] = _replace(items[base + 5], public_xy=bytes(xy))
        items[base + 6] = _replace(items[base + 6], public_xy=b"\x00" * 64)
        r, s = sw.decode_dss_signature(items[base + 7].signature)
        items[base + 7] = _replace(items[base + 7],
                                   signature=sw.encode_dss_signature(r, sw.N - s))
        expect[[base, base + 1, base + 3, base + 4, base + 5, base + 6,
                base + 7]] = False
