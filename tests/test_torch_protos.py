"""The port's protos (wire, messages, protoutil) against the JAX
reference: seeded envelopes and blocks encode to the same bytes in both
packages and decode across, tx ids and the txflags metadata agree."""
import hashlib
import random

import pytest

from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jpu
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil as pu
from fabric_mod_tpu_torch.utils import fixtures


def _build(mod, util, seed):
    """A seeded endorser transaction and a block of three, built with
    one package's messages and protoutil."""
    rng = random.Random(seed)
    envs = []
    for i in range(3):
        creator = mod.SerializedIdentity(
            mspid=f"Org{i + 1}", id_bytes=rng.randbytes(40)).encode()
        nonce = rng.randbytes(24)
        tx_id = util.compute_tx_id(nonce, creator)
        kv = mod.KVRWSet(
            reads=[mod.KVRead(key="a", version=mod.Version(block_num=1,
                                                          tx_num=i))],
            range_queries_info=[mod.RangeQueryInfo(
                start_key="a", end_key="z", itr_exhausted=1,
                reads_merkle_hash=rng.randbytes(32))],
            writes=[mod.KVWrite(key=f"k{i}", value=rng.randbytes(9)),
                    mod.KVWrite(key="gone", is_delete=1)],
            metadata_writes=[mod.KVMetadataWrite(key="a", entries=[
                mod.KVMetadataEntry(name="VALIDATION_PARAMETER",
                                    value=rng.randbytes(5))])])
        rw = mod.TxReadWriteSet(ns_rwset=[mod.NsReadWriteSet(
            namespace="mycc", rwset=kv.encode())])
        cca = mod.ChaincodeAction(
            results=rw.encode(), response=mod.Response(status=200),
            chaincode_id=mod.ChaincodeID(name="mycc"))
        prp = mod.ProposalResponsePayload(
            proposal_hash=hashlib.sha256(tx_id.encode()).digest(),
            extension=cca.encode()).encode()
        cap = mod.ChaincodeActionPayload(action=mod.ChaincodeEndorsedAction(
            proposal_response_payload=prp, endorsements=[
                mod.Endorsement(endorser=rng.randbytes(30),
                                signature=rng.randbytes(70))]))
        tx = mod.Transaction(actions=[mod.TransactionAction(
            payload=cap.encode())])
        ch = util.make_channel_header(
            mod.HeaderType.ENDORSER_TRANSACTION, "bench", tx_id=tx_id,
            timestamp=1_700_000_000_000_000_000 + i)
        payload = util.make_payload(
            ch, util.make_signature_header(creator, nonce), tx.encode())
        envs.append(mod.Envelope(payload=payload.encode(),
                                 signature=rng.randbytes(71)))
    block = util.new_block(7, rng.randbytes(32), envs)
    return envs, block


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_envelopes_and_blocks_encode_equal(seed):
    envs, block = _build(m, pu, seed)
    jenvs, jblock = _build(jm, jpu, seed)
    assert [e.encode() for e in envs] == [e.encode() for e in jenvs]
    assert block.encode() == jblock.encode()
    assert pu.block_header_hash(block.header) == \
        jpu.block_header_hash(jblock.header)
    assert pu.block_data_hash(block.data) == jpu.block_data_hash(jblock.data)


def test_compute_tx_id_and_txflags_metadata():
    rng = random.Random(3)
    for _ in range(20):
        nonce, creator = rng.randbytes(24), rng.randbytes(rng.randrange(200))
        assert pu.compute_tx_id(nonce, creator) == \
            jpu.compute_tx_id(nonce, creator)
    _envs, block = _build(m, pu, 4)
    _jenvs, jblock = _build(jm, jpu, 4)
    assert pu.block_txflags(block) == jpu.block_txflags(jblock)
    flags = bytes([0, 10, 11])
    pu.set_block_txflags(block, flags)
    jpu.set_block_txflags(jblock, flags)
    assert block.encode() == jblock.encode()
    assert pu.block_txflags(m.Block.decode(jblock.encode())) == \
        bytearray(flags)
    assert jpu.block_txflags(jm.Block.decode(block.encode())) == \
        bytearray(flags)
    assert m.TxValidationCode.VALID == jm.TxValidationCode.VALID
    codes = [name for name in dir(jm.TxValidationCode)
             if name.isupper()]
    assert all(getattr(m.TxValidationCode, c) == getattr(jm.TxValidationCode, c)
               for c in codes)


def test_fixture_blocks_round_trip_through_reference():
    """The port's commit fixtures decode with the reference's messages
    and re-encode to the same bytes, and unpack to the same tx ids."""
    world = fixtures.make_commit_world()
    blocks, expected = fixtures.make_commit_blocks(world, 2, 16)
    for raw, flags in zip(blocks, expected):
        jblock = jm.Block.decode(raw)
        assert jblock.encode() == raw
        ids = [pu.envelope_channel_header(e).tx_id
               for e in pu.get_envelopes(m.Block.decode(raw))]
        jids = [jpu.envelope_channel_header(e).tx_id
                for e in jpu.get_envelopes(jblock)]
        assert ids == jids and len(flags) == len(ids)
