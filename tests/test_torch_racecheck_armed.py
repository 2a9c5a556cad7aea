"""The port's commit paths with every guard armed.

(a) The reference's seeded stress (tests/test_racecheck.py
`test_seeded_stress_ledger_commit_vs_readers`) on the port's durable
KvLedger: commits race readers and transient-store writers; the ranks
kvledger 10 < transientstore 20 < pvtdatastore 30 hold on every
interleaving, and the state equals the reference's KvLedger over the
same blocks.  (b) A solo port Network on a host verifier commits two
small blocks under `concurrency.armed()`: no RaceError, no registered
worker left, the lock-order registry saw the commit path's orderings,
and the flags and fingerprint equal an unarmed run of the same stream.
"""
import random
import threading

import pytest

from fabric_mod_tpu_torch import concurrency
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

BLOCK_TXS = 8
N_TX = 2 * BLOCK_TXS


def _endorser_env(txid: str, rwset) -> m.Envelope:
    cca = m.ChaincodeAction(results=rwset.encode())
    prp = m.ProposalResponsePayload(proposal_hash=b"\x01" * 32,
                                    extension=cca.encode())
    cea = m.ChaincodeEndorsedAction(proposal_response_payload=prp.encode(),
                                    endorsements=[])
    cap = m.ChaincodeActionPayload(action=cea)
    tx = m.Transaction(actions=[m.TransactionAction(payload=cap.encode())])
    ch = protoutil.make_channel_header(m.HeaderType.ENDORSER_TRANSACTION,
                                       "ch", tx_id=txid)
    sh = protoutil.make_signature_header(b"creator",
                                         b"nonce-" + txid.encode())
    payload = protoutil.make_payload(ch, sh, tx.encode())
    return m.Envelope(payload=payload.encode(), signature=b"")


@pytest.mark.parametrize("seed", [1, 7, 42])
def test_seeded_stress_ledger_commit_vs_readers(tmp_path, seed):
    from fabric_mod_tpu.ledger.kvledger import KvLedger as RefLedger
    from fabric_mod_tpu.protos import messages as rm
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.ledger.pvtdata import (PvtDataStore,
                                                     TransientStore)
    from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder

    rng = random.Random(seed)
    led = KvLedger("ch", str(tmp_path / "l"))
    transient = TransientStore(dir_path=str(tmp_path / "t"))
    pvt = PvtDataStore(dir_path=str(tmp_path / "p"))
    led.attach_pvt(transient, pvt)
    ref = RefLedger(str(tmp_path / "ref"), "ch", durable=False)
    errs = []
    stop = threading.Event()

    def reader():
        r = random.Random(rng.random())
        while not stop.is_set():
            qe = led.new_query_executor()
            qe.get_state("ns", f"k{r.randrange(50)}")
            led.get_block_by_number(r.randrange(1, 40))
            led.state_fingerprint()
            if r.random() < 0.3:
                threading.Event().wait(r.random() * 0.002)

    def transient_writer():
        r = random.Random(rng.random())
        i = 0
        while not stop.is_set():
            transient.persist(f"side{seed}-{i}", 0, m.TxPvtReadWriteSet())
            i += 1
            if r.random() < 0.5:
                threading.Event().wait(r.random() * 0.002)

    def guarded(f):
        def run():
            try:
                f()
            except Exception as e:        # noqa: BLE001
                errs.append(e)
        return run

    with concurrency.armed():
        threads = [threading.Thread(target=guarded(f), daemon=True)
                   for f in (reader, reader, transient_writer)]
        for t in threads:
            t.start()
        try:
            for n in range(30):
                b = RWSetBuilder()
                b.add_write("ns", f"k{rng.randrange(50)}", b"v%d" % n)
                env = _endorser_env(f"tx{seed}-{n}", b.build())
                prev = (protoutil.block_header_hash(
                    led.get_block_by_number(led.height - 1).header)
                    if led.height else b"")
                blk = protoutil.new_block(led.height, prev, [env])
                led.commit_block(blk, [m.TxValidationCode.VALID])
                ref.commit_block(rm.Block.decode(blk.encode()),
                                 [rm.TxValidationCode.VALID])
                if rng.random() < 0.4:
                    threading.Event().wait(rng.random() * 0.003)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
    try:
        assert not errs, errs
        assert led.height == ref.height == 30
        assert led.state_fingerprint() == ref.state_fingerprint()
    finally:
        led.close()
        ref.close()


def _run(root, material, submits, expected, armed: bool):
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
    from fabric_mod_tpu_torch.orderer import BroadcastError
    before = set(concurrency.live_registered())
    concurrency.lock_registry().clear()
    with concurrency.armed(armed):
        net = e2e.Network(root, material, verifier=SwVerifier())
        try:
            def feed():
                for env, ok in submits:
                    try:
                        net.broadcast.submit(env)
                    except BroadcastError:
                        assert not ok
            _c, committed, _s = e2e.commit_until(net, len(expected), 60,
                                                 feed=feed)
            flags = [f for n in range(1, net.ledger.height)
                     for f in protoutil.block_txflags(
                         net.ledger.get_block_by_number(n))]
            fp = net.ledger.state_fingerprint()
        finally:
            net.close()
        leaked = [t for t in concurrency.live_registered()
                  if t not in before]
    edges = concurrency.lock_registry().edge_count()
    return committed, flags, fp, leaked, edges


def test_armed_solo_network_commits_like_an_unarmed_one(tmp_path):
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
    from fabric_mod_tpu_torch.utils import fixtures
    material = fixtures.make_network_material(
        3, max_message_count=BLOCK_TXS, batch_timeout="5s")
    net = e2e.Network(str(tmp_path / "endorse"), material,
                      verifier=SwVerifier())
    try:
        submits, expected = fixtures.make_e2e_stream(net, N_TX,
                                                     plant_every=8)
    finally:
        net.close()
    armed = _run(str(tmp_path / "armed"), material, submits, expected, True)
    plain = _run(str(tmp_path / "plain"), material, submits, expected,
                 False)
    for committed, flags, _fp, leaked, _e in (armed, plain):
        assert committed == N_TX
        assert flags == list(expected)
        assert leaked == []
    assert armed[2] == plain[2]
    assert armed[4] > 0                  # the guards observed orderings
