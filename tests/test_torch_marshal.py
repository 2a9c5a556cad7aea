"""The port's host marshalling (bccsp/gpu.marshal_items, ops/p256
range_checks and the verify core's packed buffer) and its pure-python
signer against the JAX package's: byte planes, pre_ok and message
words, including malformed DER, high-S, empty and non-bytes messages."""
import hashlib

import numpy as np
import pytest

from fabric_mod_tpu.bccsp import api as japi
from fabric_mod_tpu.bccsp import sw as jsw
from fabric_mod_tpu.bccsp import tpu as jtpu
from fabric_mod_tpu.ops import p256 as jp256
from fabric_mod_tpu_torch.bccsp import api as tapi
from fabric_mod_tpu_torch.bccsp import gpu as tgpu
from fabric_mod_tpu_torch.bccsp import sw as tsw
from fabric_mod_tpu_torch.ops import p256 as tp256
from fabric_mod_tpu_torch.utils import fixtures


def _adversarial_fields():
    """(digest, signature, public_xy, message) rows covering the marshal
    rules: valid, high-S, malformed DER, short digest, bad key length,
    raw messages (incl. empty), a non-bytes message."""
    key = tsw.PrivateKey.from_seed(b"marshal")
    rows = []
    for i in range(4):
        d = hashlib.sha256(b"m%d" % i).digest()
        rows.append((d, key.sign(d), key.public_xy(), None))
    d0, sig0, xy, _ = rows[0]
    r, s = tsw.decode_dss_signature(sig0)
    rows.append((d0, tsw.encode_dss_signature(r, tsw.N - s), xy, None))  # high S
    rows.append((d0, sig0[:-1], xy, None))                 # truncated DER
    rows.append((d0, sig0 + b"\x00", xy, None))            # trailing byte
    rows.append((d0, b"\x30\x81" + sig0[1:], xy, None))    # long-form length
    rows.append((d0[:31], sig0, xy, None))                 # short digest
    rows.append((d0, sig0, xy[:63], None))                 # short key
    for m in (b"", b"raw message", b"y" * 1500):
        rows.append((b"", key.sign(hashlib.sha256(m).digest()), xy, m))
    rows.append((b"", sig0, xy, 12345))                    # non-bytes message
    return rows


@pytest.mark.parametrize("size", [None, 64])
def test_marshal_items_matches_reference(size):
    rows = _adversarial_fields()
    want = jtpu.marshal_items([japi.VerifyItem(*r) for r in rows], size)
    got = tgpu.marshal_items([tapi.VerifyItem(*r) for r in rows], size)
    for w, g in zip(want[:6], got[:6]):
        assert np.array_equal(w, g)
    assert got[5].tolist()[:len(rows)] == [
        True, True, True, True, False, False, False, False, False, False,
        True, True, True, False]
    # the message lane: the reference's words plane is rounded up to a
    # power of two blocks, the port's is as wide as the longest message
    (w_words, *w_rest), (g_words, *g_rest) = want[6], got[6]
    assert g_words.shape[1] == max(got[6][1]) == 24 < w_words.shape[1]
    assert np.array_equal(w_words[:, :g_words.shape[1]], g_words)
    assert not w_words[:, g_words.shape[1]:].any()
    for w, g in zip(w_rest, g_rest):
        assert np.array_equal(w, g)


def test_marshal_without_raw_messages_has_no_message_lane():
    items, _ = fixtures.make_verify_items(5)
    assert tgpu.marshal_items(items, 8)[6] is None


def test_marshal_inputs_matches_reference():
    """The port's host prologue (p256.range_checks and the verify core's
    packed words, ops/p256_core.pack) against the reference's
    marshal_inputs: the same range verdicts and rn_lt_p flags, and each
    value's words equal to the reference's limbs as integers."""
    from fabric_mod_tpu_torch.ops import p256_core
    d, r, s, qx, qy, _ = fixtures.signature_arrays(6)
    r = r.copy()
    r[2] = np.frombuffer(tp256.N.to_bytes(32, "big"), np.uint8)
    want_args, want_ok = jp256.marshal_inputs(d, r, s, qx, qy)
    planes, got_ok, rn_lt_p = tp256.range_checks(d, r, s, qx, qy)
    assert np.array_equal(want_ok, got_ok)
    assert np.array_equal(np.asarray(want_args[5]), rn_lt_p)
    packed = p256_core.pack(planes, got_ok, np.ones(6, bool), rn_lt_p)
    words = packed.view(np.uint32).astype(object)
    rows = (p256_core.ROW_E, p256_core.ROW_R, p256_core.ROW_S,
            p256_core.ROW_QX, p256_core.ROW_QY)
    for row, limbs in zip(rows, want_args[:5]):
        limbs = np.asarray(limbs)
        for lane in range(6):
            assert sum(int(w) << (32 * k) for k, w in
                       enumerate(words[row:row + 8, lane])) == \
                sum(int(v) << (9 * i) for i, v in enumerate(limbs[:, lane]))


def test_port_signatures_verify_under_reference_sw():
    """RFC 6979 + low-S signatures from the port's pure-python signer
    are accepted by the reference's software provider, and the two
    software verdicts agree on tampered inputs."""
    key = tsw.PrivateKey.from_seed(b"cross")
    csp = jsw.SwCSP()
    pub = csp.key_import(b"\x04" + key.public_xy(), "P256-pub")
    for i in range(3):
        d = hashlib.sha256(b"cross-%d" % i).digest()
        sig = key.sign(d)
        assert tsw.decode_dss_signature(sig)[1] <= tsw.LOW_S_MAX
        assert csp.verify(pub, sig, d) and tsw.verify(key.public_xy(), sig, d)
        bad = bytes([d[0] ^ 1]) + d[1:]
        assert not csp.verify(pub, sig, bad)
        assert not tsw.verify(key.public_xy(), sig, bad)


def test_block_fixture_expectations_hold_in_software():
    """make_block's expected mask is what the software verify says, and
    its items are distinct (dedup would otherwise hide lanes)."""
    items, expect = fixtures.make_block(0, n_tx=6, raw_endorsers=True)
    assert len(items) == 18 and len(set(items)) == 18
    assert [tsw.verify_item(it) for it in items] == expect.tolist()
    assert (~expect).sum() == 7
