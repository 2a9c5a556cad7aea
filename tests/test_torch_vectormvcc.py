"""The port's vectorized MVCC (fabric_mod_tpu_torch/ledger/mvcc.py
`validate_and_prepare_batch_vectorized` over protos/batchdecode.py's
planes) against the reference's and against the port's own generic
pass, and the block commit (handed its stage-time rwsets, so the
vectorized pass, or committed without them, so the generic one) against
the reference TxValidator run with FABRIC_MOD_TPU_VECTOR_MVCC on.

The MVCC differential runs seeded random blocks (stale and fresh reads,
reads of absent keys, deletes, range queries with honest and bogus
fingerprints, metadata writes, in-block conflicts, upstream-invalid
incoming flags) routed through the columnar sentinel, a generic rwset
or none: the (flags, update batch, tx writes) triple must be equal.
The commit differential adds a block with a two-action tx (the body
scanner's fallback), so the columnar path and its fallback both run;
the reference's staged fallback count must equal the port's."""
import random

import pytest
import torch

from fabric_mod_tpu.ledger import mvcc as jmvcc
from fabric_mod_tpu.ledger import statedb as jstatedb
from fabric_mod_tpu.protos import batchdecode as jbd
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch import convert
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger import mvcc as tmvcc
from fabric_mod_tpu_torch.ledger import statedb as tstatedb
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.protos import batchdecode as tbd
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from tests.test_torch_txvalidator import _reference_world_pems

V = m.TxValidationCode


def _tx_data(rng: random.Random, results: bytes) -> bytes:
    cca = m.ChaincodeAction(results=results, events=b"",
                            response=m.Response(status=200),
                            chaincode_id=m.ChaincodeID(name="mycc"))
    prp = m.ProposalResponsePayload(proposal_hash=rng.randbytes(32),
                                    extension=cca.encode()).encode()
    cap = m.ChaincodeActionPayload(action=m.ChaincodeEndorsedAction(
        proposal_response_payload=prp,
        endorsements=[m.Endorsement(endorser=b"e", signature=b"s")]))
    return m.Transaction(
        actions=[m.TransactionAction(payload=cap.encode())]).encode()


def _rwset(rng: random.Random) -> bytes:
    b = RWSetBuilder()
    for _ in range(rng.randrange(0, 4)):
        b.add_read("cc%d" % rng.randrange(2), "k%d" % rng.randrange(40),
                   (rng.randrange(4), rng.randrange(4))
                   if rng.random() < 0.7 else None)
    for _ in range(rng.randrange(0, 3)):
        b.add_write("cc%d" % rng.randrange(2), "k%d" % rng.randrange(40),
                    None if rng.random() < 0.25
                    else b"w%d" % rng.randrange(99))
    if rng.random() < 0.35:
        b.add_range_query("cc0", "k1", "k3", rng.random() < 0.5,
                          [] if rng.random() < 0.5 else [("k1", (1, 1))])
    if rng.random() < 0.3:
        b.add_metadata_write("cc0", "k%d" % rng.randrange(40),
                             "VALIDATION_PARAMETER", b"p")
    return b.build().encode()


def _prefill(statedb, seed: int):
    rng = random.Random(seed)
    db, batch = statedb.VersionedDB(), statedb.UpdateBatch()
    for i in range(40):
        for ns, p in (("cc0", 0.8), ("cc1", 0.4)):
            if rng.random() < p:
                batch.put(ns, "k%d" % i, b"seed%d" % i,
                          (rng.randrange(3), rng.randrange(4)))
    batch.put_metadata("cc0", "k0", {"OTHER": b"m"}, (0, 0))
    db.apply_updates(batch, 2)
    return db


def _snapshot(batch):
    return (dict(batch.updates),
            {k: (dict(e), v) for k, (e, v) in batch.meta_updates.items()})


@pytest.mark.parametrize("seed", range(4))
def test_vector_mvcc_matches_reference_and_generic(seed):
    rng = random.Random(1000 + seed)
    for blk in range(15):
        n = rng.randrange(5, 12)
        results = [_rwset(rng) for _ in range(n)]
        datas = [_tx_data(rng, r) for r in results]
        planes = tbd.decode_block_rwsets(datas)
        jplanes = jbd.decode_block_rwsets(datas)
        assert planes.fallbacks == jplanes.fallbacks == 0
        port_vec, ref_vec, port_gen = [], [], []
        for i, r in enumerate(results):
            flag = V.VALID if rng.random() < 0.8 else \
                V.ENDORSEMENT_POLICY_FAILURE
            route = rng.random()
            rw, jrw = m.TxReadWriteSet.decode(r), jm.TxReadWriteSet.decode(r)
            if route < 0.6:
                port_vec.append(("t%d" % i, tmvcc.COLUMNAR, flag))
                ref_vec.append(("t%d" % i, jmvcc.COLUMNAR, flag))
            elif route < 0.9:
                port_vec.append(("t%d" % i, rw, flag))
                ref_vec.append(("t%d" % i, jrw, flag))
            else:
                rw = jrw = None
                port_vec.append(("t%d" % i, None, flag))
                ref_vec.append(("t%d" % i, None, flag))
            port_gen.append(("t%d" % i, rw, flag))
        seed_db = seed * 100 + blk
        fv, bv, wv = tmvcc.validate_and_prepare_batch_vectorized(
            port_vec, _prefill(tstatedb, seed_db), 7, planes)
        fg, bg, wg = tmvcc.validate_and_prepare_batch(
            port_gen, _prefill(tstatedb, seed_db), 7)
        fr, br, wr = jmvcc.validate_and_prepare_batch_vectorized(
            ref_vec, _prefill(jstatedb, seed_db), 7, jplanes)
        assert fv == fg == fr, blk
        assert _snapshot(bv) == _snapshot(bg) == _snapshot(br)
        assert wv == wg == wr


def test_get_versions_many_matches_reference():
    db, jdb = _prefill(tstatedb, 5), _prefill(jstatedb, 5)
    pairs = [(ns, "k%d" % i) for ns in ("cc0", "cc1", "cc9")
             for i in range(45)]
    assert db.get_versions_many(pairs) == jdb.get_versions_many(pairs) == \
        [db.get_version(ns, k) for ns, k in pairs]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stream():
    """The reference world carried across, 3 commit blocks of 16 txs;
    the last block's tx 2 becomes a two-action tx (re-signed by the
    client), which the body scanner leaves to the generic decode."""
    ca_pems, signers, policy = _reference_world_pems()
    world = convert.world_from_reference(ca_pems, signers, policy)
    blocks, expected = fixtures.make_commit_blocks(world, 3, 16)
    last = m.Block.decode(blocks[-1])
    envs = protoutil.get_envelopes(last)
    payload = protoutil.unmarshal_envelope_payload(envs[2])
    tx = protoutil.extract_endorser_tx(payload)
    payload = m.Payload(header=payload.header, data=m.Transaction(
        actions=tx.actions * 2).encode())
    envs[2] = protoutil.sign_envelope(payload, world.signers["client"])
    blocks[-1] = protoutil.new_block(
        last.header.number, last.header.previous_hash, envs).encode()
    return ca_pems, policy, world, blocks, expected


def _reference_commit(ca_pems, policy, blocks, root):
    """The reference TxValidator + KvLedger with FABRIC_MOD_TPU_VECTOR_MVCC
    on: (per-block flags, per-block body fallbacks, fingerprint)."""
    from fabric_mod_tpu.bccsp.sw import SwCSP
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.ledger import KvLedger
    from fabric_mod_tpu.msp.cache import CachedMsp
    from fabric_mod_tpu.msp.identities import deserialize_cert
    from fabric_mod_tpu.msp.mspimpl import Msp, MspManager
    from fabric_mod_tpu.peer import TxValidator, ValidationInfoProvider
    from fabric_mod_tpu.peer.txvalidator import VALIDATION_PARAMETER
    from fabric_mod_tpu.policy import ApplicationPolicyEvaluator
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FABRIC_MOD_TPU_VECTOR_MVCC", "1")
        mp.delenv("FABRIC_MOD_TPU_TENSOR_POLICY", raising=False)
        mp.delenv("FABRIC_MOD_TPU_FUSED_HASH", raising=False)
        csp = SwCSP()
        mgr = CachedMsp(MspManager([Msp(o, csp, [deserialize_cert(p)])
                                    for o, p in ca_pems.items()]))
        led = KvLedger(str(root), "bench")

        def state_vp(ns, key):
            meta = led.state.get_metadata(ns, key)
            return meta.get(VALIDATION_PARAMETER) if meta else None
        validator = TxValidator(
            "bench", mgr, ApplicationPolicyEvaluator(mgr),
            FakeBatchVerifier(csp), ValidationInfoProvider(policy),
            tx_id_exists=led.tx_id_exists, state_metadata=state_vp)
        flags, fallbacks = [], []
        for raw in blocks:
            block = jm.Block.decode(raw)
            staged = validator.stage(block)
            fallbacks.append(staged.rwsets.fallbacks)
            flags.append(led.commit_block(block, validator.finish(staged),
                                          rwsets=staged.rwsets))
        fp = led.state_fingerprint()
        led.close()
    return flags, fallbacks, fp


@pytest.mark.parametrize("vector", [False, True])
def test_vector_commit_equals_reference(stream, tmp_path, monkeypatch,
                                        vector):
    from fabric_mod_tpu_torch.ledger import kvledger
    ca_pems, policy, world, blocks, expected = stream
    ref_flags, ref_fallbacks, ref_fp = _reference_commit(
        ca_pems, policy, blocks, tmp_path)
    assert ref_flags[:2] == expected[:2]
    assert ref_fallbacks == [0, 0, 1]
    passes = []
    real = kvledger.validate_and_prepare_batch_vectorized

    def counted(txs, db, num, planes):
        passes.append(sum(rw is tmvcc.COLUMNAR for _t, rw, _f in txs))
        return real(txs, db, num, planes)
    monkeypatch.setattr(kvledger, "validate_and_prepare_batch_vectorized",
                        counted)
    committer = world.committer(sw.SwVerifier())
    flags, fallbacks = [], []
    for raw in blocks:
        block = m.Block.decode(raw)
        if vector:
            flags.append(committer.store_block(block))
            fallbacks.append(committer.last_timings["body_fallbacks"])
            assert committer.last_timings["spine_fallbacks"] == 0
        else:
            # committed without the stage-time rwsets: the generic pass
            staged = committer.validator.stage(block)
            fallbacks.append(staged.rwsets.fallbacks)
            flags.append(committer.ledger.commit_block(
                block, committer.validator.finish(staged)))
    # every scanner-accepted row took the columnar route when handed
    # the rwsets, and none without them
    assert passes == ([16, 16, 15] if vector else [])
    assert flags == ref_flags
    assert fallbacks == ref_fallbacks
    assert committer.ledger.state_fingerprint() == ref_fp
