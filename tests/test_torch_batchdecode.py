"""The port's columnar block decode (fabric_mod_tpu_torch/protos/
batchdecode.py) against the reference's (fabric_mod_tpu/protos/
batchdecode.py) on the same bytes: `decode_block_spine` over encoded
commit blocks of every planted kind (utils/fixtures.make_commit_blocks)
and `decode_block_rwsets` over their endorser-tx bodies and over seeded
synthetic bodies (reads with and without versions, deletes, range
queries, metadata writes, private-data collection hashes, no-action and
no-endorsement txs), then under a seeded corruption fuzz.  Accepted and
None rows must agree, every plane and every decoded value must be equal,
and so must the fallback counts; every accepted spine row must also equal
the port's own generic decode."""
import random

import numpy as np
import pytest

from fabric_mod_tpu.ledger.rwsetutil import RWSetBuilder as JRWSetBuilder
from fabric_mod_tpu.protos import batchdecode as jbd
from fabric_mod_tpu_torch.protos import batchdecode as tbd
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

PLANE_ARRAYS = ("read_tx", "read_nsi", "read_has_ver", "read_vb", "read_vt",
                "read_bounds", "write_tx", "write_bounds", "range_tx",
                "range_nsi", "range_bounds", "meta_tx", "meta_bounds")
PLANE_LISTS = ("read_ns", "read_key", "write_ns", "write_key", "write_del",
               "write_val", "range_ns", "meta_ns", "meta_key",
               "meta_entries")
BODY_FIELDS = ("ns", "prp", "endorsements", "no_action", "has_pvt", "groups")


@pytest.fixture(scope="module")
def commit_blocks():
    """Two chained 20-tx blocks with every planted kind of the fixture."""
    world = fixtures.make_commit_world()
    blocks, _expected = fixtures.make_commit_blocks(world, 2, 20)
    return [m.Block.decode(raw).data.data for raw in blocks]


def _assert_spines_equal(datas):
    got = tbd.decode_block_spine(datas)
    want = jbd.decode_block_spine(datas)
    assert [g is None for g in got] == [w is None for w in want]
    for data, g, w in zip(datas, got, want):
        if g is None:
            continue
        for part in ("env", "payload", "ch", "sh"):
            assert getattr(g, part).encode() == getattr(w, part).encode()
        # value identity with the port's generic decode
        env = m.Envelope.decode(data)
        payload = protoutil.unmarshal_envelope_payload(env)
        assert g.env == env and g.payload == payload
        assert g.ch == m.ChannelHeader.decode(payload.header.channel_header)
        assert g.sh == m.SignatureHeader.decode(
            payload.header.signature_header)
    return got


def _assert_rwsets_equal(datas):
    got = tbd.decode_block_rwsets(datas)
    want = jbd.decode_block_rwsets(datas)
    assert (got is None) == (want is None)
    if got is None:
        return None
    assert got.n == want.n and got.fallbacks == want.fallbacks
    assert got.txids == want.txids and got.types == want.types
    for g, w in zip(got.bodies, want.bodies):
        assert (g is None) == (w is None)
        if g is not None:
            for f in BODY_FIELDS:
                assert getattr(g, f) == getattr(w, f), f
    for name in PLANE_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in PLANE_LISTS:
        assert list(getattr(got, name)) == list(getattr(want, name)), name
    assert [q.encode() for q in got.range_rqi] == \
        [q.encode() for q in want.range_rqi]
    return got


def _body_datas(spines):
    return [s.payload.data if s is not None
            and s.ch.type == m.HeaderType.ENDORSER_TRANSACTION else None
            for s in spines]


def test_commit_blocks_spine_and_bodies_match_reference(commit_blocks):
    for datas in commit_blocks:
        spines = _assert_spines_equal(datas)
        assert all(s is not None for s in spines)
        rwsets = _assert_rwsets_equal(_body_datas(spines))
        assert rwsets is not None and rwsets.fallbacks == 0
        assert all(b is not None for b in rwsets.bodies)


def test_tiny_blocks_are_not_scanned(commit_blocks):
    datas = commit_blocks[0][:3]
    assert tbd.decode_block_spine(datas) == [None] * 3
    assert tbd.decode_block_rwsets(_body_datas(
        jbd.decode_block_spine(commit_blocks[0])[:3])) is None
    _assert_spines_equal(datas)


def _rand_rwset(rng: random.Random) -> bytes:
    """Rwset bytes with every row kind the planes carry (the reference's
    builder: it also writes private-data collection hashes)."""
    b = JRWSetBuilder()
    for nsi in range(rng.randrange(1, 3)):
        ns = "cc%d" % nsi
        for _ in range(rng.randrange(0, 4)):
            ver = ((rng.randrange(9), rng.randrange(9))
                   if rng.random() < 0.6 else None)
            b.add_read(ns, "k%d" % rng.randrange(30), ver)
        for _ in range(rng.randrange(0, 3)):
            b.add_write(ns, "k%d" % rng.randrange(30),
                        None if rng.random() < 0.2
                        else b"v%d" % rng.randrange(1000))
        if rng.random() < 0.3:
            b.add_range_query(ns, "k1", "k2", rng.random() < 0.5,
                              [("k1", (rng.randrange(5), 0))]
                              if rng.random() < 0.5 else [])
        if rng.random() < 0.3:
            b.add_metadata_write(ns, "k%d" % rng.randrange(30),
                                 "VALIDATION_PARAMETER",
                                 b"pol%d" % rng.randrange(4))
        if rng.random() < 0.25:
            b.add_pvt_write(ns, "collA", "pk%d" % rng.randrange(5), b"s")
    return b.build().encode()


def _tx_data(rng: random.Random, n_endorsers: int = 2) -> bytes:
    """One Transaction encoding (what payload.data carries)."""
    cca = m.ChaincodeAction(
        results=_rand_rwset(rng), events=b"ev",
        response=m.Response(status=200, payload=b"rp"),
        chaincode_id=m.ChaincodeID(name="mycc"))
    prp = m.ProposalResponsePayload(
        proposal_hash=rng.randbytes(32), extension=cca.encode()).encode()
    ends = [m.Endorsement(endorser=b"org%d-id" % k,
                          signature=b"sig%d" % rng.randrange(99))
            for k in range(n_endorsers)]
    cap = m.ChaincodeActionPayload(action=m.ChaincodeEndorsedAction(
        proposal_response_payload=prp, endorsements=ends))
    return m.Transaction(
        actions=[m.TransactionAction(payload=cap.encode())]).encode()


def test_synthetic_bodies_match_reference():
    rng = random.Random(18)
    datas = [_tx_data(rng) for _ in range(24)]
    datas[3] = m.Transaction().encode()              # no action
    datas[7] = _tx_data(rng, n_endorsers=0)          # no endorsement
    datas[11] = None                                 # not an endorser tx
    tx = m.Transaction.decode(datas[13])
    datas[13] = m.Transaction(actions=tx.actions * 2).encode()  # 2 actions
    rwsets = _assert_rwsets_equal(datas)
    assert rwsets.fallbacks == 1 and rwsets.bodies[13] is None
    assert rwsets.bodies[3].no_action and rwsets.bodies[11] is None
    assert any(b.has_pvt for b in rwsets.bodies if b is not None)
    assert len(rwsets.range_rqi) and len(rwsets.meta_key)


def _corrupt(rng: random.Random, raw: bytes) -> bytes:
    raw = bytearray(raw)
    mode = rng.randrange(3)
    if mode == 0 and raw:
        raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
    elif mode == 1:
        raw = raw[:rng.randrange(len(raw) + 1)]
    else:
        raw += rng.randbytes(rng.randrange(1, 6))
    return bytes(raw)


def test_corruption_fuzz_bodies():
    """Flip, truncate or extend one body of each 5-row block: both
    decoders accept and reject the same rows with the same values."""
    rng = random.Random(77)
    fallbacks = 0
    for _ in range(80):
        datas = [_tx_data(rng) for _ in range(5)]
        j = rng.randrange(len(datas))
        datas[j] = _corrupt(rng, datas[j])
        fallbacks += _assert_rwsets_equal(datas).fallbacks
    assert fallbacks > 10


def test_corruption_fuzz_spines(commit_blocks):
    """The same fuzz on whole envelopes of a commit block."""
    rng = random.Random(78)
    rejected = 0
    base = list(commit_blocks[1][:6])
    for _ in range(60):
        datas = list(base)
        j = rng.randrange(len(datas))
        datas[j] = _corrupt(rng, datas[j])
        spines = _assert_spines_equal(datas)
        rejected += sum(s is None for s in spines)
        _assert_rwsets_equal(_body_datas(spines))
    assert rejected > 10
