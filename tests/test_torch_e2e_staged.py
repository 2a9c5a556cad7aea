"""The staged ingress path end to end, port against reference: the port's
`Network(ingress_batching=True, staged_batch=N)` takes an order-free
stream (fixtures.make_e2e_stream(order_free=True)) from concurrent
submitters, which reorder it; each txid's flag must be the
construction's, which holds because the stream plants only kinds whose
flag does not depend on the order.  The JAX package's `Network` then
takes the port's ordered envelopes (and the tampered ones) from one
thread: block data, flags and the state fingerprint must agree.  The
port's verifier is the host one for 2 blocks of 20; one block of 8 runs
the GpuVerifier's CPU path (seconds a call), which the ingress service
drives through `verify_many_async`, as on the card."""
import os
import threading

import pytest
import torch
from fabric_mod_tpu.e2e import Network as JNetwork
from fabric_mod_tpu.orderer import BroadcastError as JBroadcastError
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu.protos import protoutil as jprotoutil

from fabric_mod_tpu_torch import convert, e2e
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.orderer import BroadcastError
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The GpuVerifier's CPU path is many small ops: one intra-op thread
    a worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flags_by_txid(ledger, pu, decode):
    out = {}
    for num in range(1, ledger.height):
        block = ledger.get_block_by_number(num)
        for raw, flag in zip(block.data.data, pu.block_txflags(block)):
            out[pu.envelope_channel_header(decode(raw)).tx_id] = int(flag)
    return out


def test_staged_network_equals_reference(tmp_path, monkeypatch):
    _staged_network_equals_reference(tmp_path, monkeypatch, sw.SwVerifier(),
                                     block_txs=20, n_blocks=2, submitters=4,
                                     staged_batch=16, plant_every=10)


def test_staged_network_on_the_gpu_verifier_equals_reference(
        tmp_path, monkeypatch):
    """Lanes, the ingress service's asynchronous dispatch and the
    GpuVerifier together, as chip_smoke's staged arm runs them.  Each
    CPU verify call costs seconds, so 8 submitters, one envelope each
    but one, keep the cohorts few."""
    _staged_network_equals_reference(
        tmp_path, monkeypatch, gpu.GpuVerifier(device="cpu", buckets=(32,)),
        block_txs=8, n_blocks=1, submitters=8, staged_batch=8,
        plant_every=8)


def _staged_network_equals_reference(tmp_path, monkeypatch, verifier,
                                     block_txs, n_blocks, submitters,
                                     staged_batch, plant_every):
    n_tx = n_blocks * block_txs
    for knob in ("FABRIC_MOD_TPU_TENSOR_POLICY",
                 "FABRIC_MOD_TPU_COMMIT_PIPELINE",
                 "FABRIC_MOD_TPU_STAGED_BROADCAST"):
        monkeypatch.delenv(knob, raising=False)
    root = str(tmp_path)
    ref = JNetwork(os.path.join(root, "ref"), max_message_count=block_txs,
                   batch_timeout="60s")
    port = None
    try:
        port = e2e.Network(os.path.join(root, "port"),
                           material=convert.network_material_from_reference(
                               ref),
                           verifier=verifier, ingress_batching=True,
                           staged_batch=staged_batch)
        submits, expected = fixtures.make_e2e_stream(
            port, n_tx, plant_every=plant_every, order_free=True)
        accepted = [env for env, ok in submits if ok]
        want = {protoutil.envelope_channel_header(env).tx_id: int(flag)
                for env, flag in zip(accepted, expected)}
        cohorts = []
        verify_many = port.ingress_service.verify_many

        def counted(items, **kw):
            cohorts.append(len(items))
            return verify_many(items, **kw)
        port.support.processor._verify_many = counted

        outcome, lock = {}, threading.Lock()

        def submit(share):
            for env, ok in share:
                try:
                    port.broadcast.submit(env)
                    got = True
                except BroadcastError:
                    got = False
                with lock:
                    outcome[protoutil.envelope_channel_header(env).tx_id,
                            ok] = got

        def feed():
            threads = [threading.Thread(target=submit,
                                        args=(submits[k::submitters],))
                       for k in range(submitters)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
        # the GpuVerifier's CPU calls on a loaded worker can leave the
        # deliver client longer than its default 30 s without a block
        assert e2e.commit_until(port, n_tx, 120, feed=feed,
                                idle_timeout_s=120)[1] == n_tx
        assert all(got == ok for (_txid, ok), got in outcome.items())
        assert len(outcome) == len(submits)

        # the reference takes the envelopes in the order the port's
        # orderer cut them (the keys' versions, and so the fingerprint,
        # follow the order), and the tampered ones
        blocks = range(1, n_blocks + 1)
        ordered = [bytes(raw) for num in blocks for raw in
                   port.ledger.get_block_by_number(num).data.data]
        for raw in ordered:
            ref.broadcast.submit(jm.Envelope.decode(raw))
        for env, ok in submits:
            if not ok:
                try:
                    ref.broadcast.submit(jm.Envelope.decode(env.encode()))
                    raise AssertionError("the reference accepted a "
                                         "tampered creator")
                except JBroadcastError:
                    pass
        assert ref.pump_committed(n_tx, timeout=120) == n_tx

        assert port.ledger.height == ref.ledger.height == n_blocks + 1
        for num in blocks:
            assert len(port.ledger.get_block_by_number(num).data.data) == \
                block_txs
        for num in blocks:
            b, jb = (port.ledger.get_block_by_number(num),
                     ref.ledger.get_block_by_number(num))
            assert [bytes(d) for d in b.data.data] == \
                [bytes(d) for d in jb.data.data]
            assert list(protoutil.block_txflags(b)) == \
                list(jprotoutil.block_txflags(jb))
        got = _flags_by_txid(port.ledger, protoutil, m.Envelope.decode)
        jgot = _flags_by_txid(ref.ledger, jprotoutil, jm.Envelope.decode)
        assert got == jgot == want
        assert port.ledger.state_fingerprint() == \
            ref.ledger.state_fingerprint()
        # one Writers verify call per lane drain, every envelope in one
        assert sum(cohorts) == len(submits)
        assert max(cohorts) > 1
    finally:
        if port is not None:
            port.close()
        ref.close()


def test_run_pipeline_staged_from_several_submitters():
    """run_pipeline's staged form (4 submitter threads, ingress batching
    over the host verifier) orders and commits every put and reports a
    rate."""
    stats = {}
    assert e2e.run_pipeline(12, sw.SwVerifier(), stats=stats, submitters=4,
                            staged_batch=8, ingress_batching=True) > 0
    assert stats["commit_secs"] >= stats["await_secs"] >= 0
