"""The port's SHA-256 (fabric_mod_tpu_torch/ops/sha256.py) against the JAX
reference's sha256_blocks and hashlib, and the digest as the verify
core reads it against the reference's digest_words_to_limbs."""
import hashlib
import random

import numpy as np
import torch

from fabric_mod_tpu.bccsp import der as jder
from fabric_mod_tpu.ops import p256 as jp256
from fabric_mod_tpu.ops import sha256 as jsha
from fabric_mod_tpu_torch.bccsp import der as tder
from fabric_mod_tpu_torch.ops import p256 as tp256
from fabric_mod_tpu_torch.ops import sha256 as tsha

LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 200, 1000, 2000]


def _messages(seed=11):
    rng = random.Random(seed)
    return [rng.randbytes(n) for n in LENGTHS]


def test_sha256_blocks_matches_reference_and_hashlib():
    import jax.numpy as jnp
    msgs = _messages()
    words, nb, ok = tder.pack_messages(msgs)
    assert ok.all()
    got = tsha.sha256_blocks(torch.as_tensor(words.astype(np.int64)),
                             torch.as_tensor(nb.astype(np.int64)))
    want = np.asarray(jsha.sha256_blocks(jnp.asarray(words), jnp.asarray(nb)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    digests = tsha.digest_to_bytes(got)
    for m, d in zip(msgs, digests):
        assert d.tobytes() == hashlib.sha256(m).digest()


def test_frozen_lanes_keep_initial_state():
    """nblocks = 0 lanes (pre-digested lanes of a mixed batch) freeze at H0."""
    words, nb, _ = tder.pack_messages([b"abc", b"x" * 300], rows=3)
    nb = nb.copy()
    nb[1] = 0
    got = tsha.sha256_blocks(torch.as_tensor(words.astype(np.int64)),
                             torch.as_tensor(nb.astype(np.int64)))
    assert got[1].tolist() == tsha._H0.tolist()
    assert tsha.digest_to_bytes(got[0]).tobytes() == hashlib.sha256(b"abc").digest()


def test_digest_words_to_limbs_matches_reference():
    """The raw path's digest as the verify core reads it (p256.
    digest_words_le: little-endian int32 words) holds, lane by lane, the
    value of the reference's digest_words_to_limbs limbs."""
    import jax.numpy as jnp
    msgs = _messages(12)
    words, nb, _ = jder.pack_messages(msgs)
    dw = np.asarray(jsha.sha256_blocks(jnp.asarray(words), jnp.asarray(nb)))
    want = np.asarray(jp256.digest_words_to_limbs(jnp.asarray(dw)))
    got = tp256.digest_words_le(torch.as_tensor(dw.astype(np.int64)))
    assert got.dtype == torch.int32 and got.shape == (8, len(msgs))
    got_words = got.numpy().view(np.uint32).astype(object)
    for lane in range(len(msgs)):
        value = sum(int(w) << (32 * k) for k, w in enumerate(got_words[:, lane]))
        assert value == sum(int(v) << (9 * i) for i, v in enumerate(want[:, lane]))
        assert value == int.from_bytes(hashlib.sha256(msgs[lane]).digest(), "big")
