"""Staged broadcast ingress in the port: the batched Writers check
(orderer/msgprocessor.py `process_normal_msgs`) against the JAX
reference's on the same envelopes, the coalescing verify service
(bccsp/gpu.py `BatchingVerifyService`) and the staged lanes
(orderer/stagedbroadcast.py `StagedIngress`): verdicts, the fallback
through the same seam, and closes that leave nobody blocked."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.channelconfig import Bundle as JBundle
from fabric_mod_tpu.channelconfig.configtx import (
    config_from_block as j_config_from_block)
from fabric_mod_tpu.orderer.msgprocessor import (
    StandardChannelProcessor as JProcessor)
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.orderer import (
    IngressClosedError, MsgRejectedError, StagedIngress,
    StandardChannelProcessor)
from fabric_mod_tpu_torch.policy import manager
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

MAX_BYTES = 8192


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain limb code is many small ops: one intra-op thread a
    worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def world():
    """The port's and the reference's Bundle of one genesis block (small
    absolute_max_bytes, so an oversize envelope is cheap), and the
    port's client signer."""
    material = fixtures.make_network_material(
        11, absolute_max_bytes=MAX_BYTES, preferred_max_bytes=MAX_BYTES // 2)
    block = m.Block.decode(material.genesis)
    cid, config = config_from_block(block)
    bundle = Bundle(cid, config, SwCSP())
    jcid, jconfig = j_config_from_block(jm.Block.decode(material.genesis))
    jbundle = JBundle(jcid, jconfig, JSwCSP())
    client = e2e._signer(SwCSP(), material.client)
    return bundle, jbundle, client


def _envelope(client, channel_id, data=b"tx", tamper=False):
    ch = protoutil.make_channel_header(
        m.HeaderType.ENDORSER_TRANSACTION, channel_id)
    sh = protoutil.make_signature_header(client.serialize(),
                                         protoutil.new_nonce())
    env = protoutil.sign_envelope(protoutil.make_payload(ch, sh, data), client)
    if tamper:
        env = m.Envelope(payload=env.payload,
                         signature=fixtures._flip(env.signature))
    return env


def _stream(bundle, client):
    """(envelope, expected verdict) of every slot kind: the config
    sequence, or the exception's type name.  An empty payload has no
    header to read the channel from, in both packages."""
    cid = bundle.channel_id
    return [
        (_envelope(client, cid, b"a"), 0),
        (_envelope(client, cid, b"b", tamper=True), "MsgRejectedError"),
        (_envelope(client, "otherchannel", b"c"), "MsgRejectedError"),
        (m.Envelope(payload=b"", signature=b"\x30\x00"), "AttributeError"),
        (_envelope(client, cid, b"x" * MAX_BYTES), "MsgRejectedError"),
        (_envelope(client, cid, b"d"), 0),
    ]


def _kind(v):
    return type(v).__name__ if isinstance(v, BaseException) else v


def test_process_normal_msgs_equals_reference(world):
    """Per slot, the port's batched Writers check (one GpuVerifier call
    on the CPU) gives the reference's verdict: the config sequence, or
    the same exception type — for a tampered creator, a wrong channel,
    an empty payload and an oversize envelope."""
    bundle, jbundle, client = world
    stream = _stream(bundle, client)
    calls = []
    verifier = gpu.GpuVerifier(device="cpu", buckets=(8,))

    def verify_many(items):
        calls.append(len(items))
        return verifier.verify_many(items)
    got = StandardChannelProcessor(lambda: bundle, verify_many=verify_many
                                   ).process_normal_msgs([e for e, _ in stream])
    want = JProcessor(lambda: jbundle).process_normal_msgs(
        [jm.Envelope.decode(e.encode()) for e, _ in stream])
    assert [_kind(v) for v in got] == [_kind(v) for v in want]
    assert [_kind(v) for v in got] == [k for _, k in stream]
    assert calls == [3]            # one call: the three signed in-channel


def test_batch_fault_rejudges_through_the_same_seam(world, monkeypatch):
    """When the cohort's verify call raises, each envelope is judged
    alone through the SAME verify_many, never the host verifier; a
    fault on one envelope's own call is that slot's exception."""
    bundle, _jbundle, client = world

    def host(_items):
        raise AssertionError("the host verifier was called")
    monkeypatch.setattr(manager, "_host_verify_many", host)
    stream = _stream(bundle, client)
    calls = []

    def verify_many(items):
        calls.append(len(items))
        if len(calls) == 1:
            raise RuntimeError("device fault")
        if len(calls) == 3:
            raise RuntimeError("device fault on one envelope")
        from fabric_mod_tpu_torch.bccsp import sw
        return sw.SwVerifier().verify_many(items)
    got = StandardChannelProcessor(lambda: bundle, verify_many=verify_many
                                   ).process_normal_msgs([e for e, _ in stream])
    assert calls == [3, 1, 1, 1]
    assert [_kind(v) for v in got] == [
        0, "RuntimeError", "MsgRejectedError", "AttributeError",
        "MsgRejectedError", 0]


class _FakeProcessor:
    """Verdicts by envelope value: even -> sequence 7, odd -> rejected.
    Records the cohorts; `fail_batches` makes the batched call raise."""

    def __init__(self, fail_batches=False, delay=0.0):
        self.cohorts = []
        self.singles = 0
        self.fail_batches = fail_batches
        self.delay = delay
        self._lock = threading.Lock()

    def process_normal_msg(self, env):
        with self._lock:
            self.singles += 1
        if env % 2:
            raise MsgRejectedError(f"odd {env}")
        return 7

    def process_normal_msgs(self, envs):
        with self._lock:
            self.cohorts.append(len(envs))
        time.sleep(self.delay)
        if self.fail_batches:
            raise RuntimeError("batch fault")
        out = []
        for env in envs:
            out.append(MsgRejectedError(f"odd {env}") if env % 2 else 7)
        return out


def _submit_concurrently(ingress, proc, envs, k):
    """k threads submit their share of envs; {env: verdict kind}."""
    got, lock = {}, threading.Lock()

    def run(share):
        for env in share:
            try:
                v = ingress.submit("ch", proc, env)
            except Exception as e:
                v = e
            with lock:
                got[env] = _kind(v)
    threads = [threading.Thread(target=run, args=(envs[i::k],))
               for i in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return got


@pytest.mark.parametrize("fail_batches", [False, True],
                         ids=["batched", "batch-fault"])
def test_staged_verdicts_equal_unstaged(fail_batches):
    """K concurrent submitters: every verdict equals the unstaged one,
    cohorts coalesce (some drain holds more than one envelope), and a
    raising cohort call is downgraded to per-envelope calls on the
    same processor."""
    proc = _FakeProcessor(fail_batches=fail_batches, delay=0.01)
    ingress = StagedIngress(max_batch=16)
    try:
        envs = list(range(96))
        got = _submit_concurrently(ingress, proc, envs, 8)
    finally:
        ingress.close()
    want = {}
    for env in envs:
        try:
            want[env] = _kind(_FakeProcessor().process_normal_msg(env))
        except MsgRejectedError as e:
            want[env] = _kind(e)
    assert got == want
    assert sum(proc.cohorts) == len(envs) and max(proc.cohorts) > 1
    assert max(proc.cohorts) <= 16
    assert proc.singles == (len(envs) if fail_batches else 0)


def test_close_racing_deposits_leaves_nobody_blocked():
    """Submitters that race close() each end with a verdict or a typed
    IngressClosedError; none is left blocked (16 threads, a short
    switch interval to shake out lost wake-ups)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _race_close()
    finally:
        sys.setswitchinterval(interval)


def _race_close():
    proc = _FakeProcessor(delay=0.005)
    ingress = StagedIngress(max_batch=4)
    outcomes, lock = [], threading.Lock()
    start = threading.Barrier(17)

    def run(k):
        start.wait()
        for env in range(k * 100, k * 100 + 50):
            try:
                v = ingress.submit("ch", proc, env)
            except (IngressClosedError, MsgRejectedError) as e:
                v = e
            with lock:
                outcomes.append(_kind(v))
    threads = [threading.Thread(target=run, args=(k,)) for k in range(16)]
    for t in threads:
        t.start()
    start.wait()
    time.sleep(0.05)
    ingress.close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(outcomes) == 16 * 50
    assert "IngressClosedError" in outcomes
    assert set(outcomes) <= {7, "MsgRejectedError", "IngressClosedError"}


class _CountingVerifier:
    """verify_many: True unless the item is b"bad"; b"boom" raises; a
    call waits on `gate` when given."""

    def __init__(self, gate=None):
        self.calls = []
        self.gate = gate

    def verify_many(self, items):
        if self.gate is not None:
            self.gate.wait()
        self.calls.append(len(items))
        if b"boom" in items:
            raise RuntimeError("device fault")
        return np.array([it != b"bad" for it in items])


def test_service_coalesces_concurrent_callers():
    verifier = _CountingVerifier()
    svc = gpu.BatchingVerifyService(verifier, deadline_s=0.2)
    results, barrier = {}, threading.Barrier(8)

    def call(k):
        barrier.wait()
        results[k] = svc.verify_many([b"ok", b"bad", b"ok", b"ok"])
    threads = [threading.Thread(target=call, args=(k,)) for k in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        svc.close()
    assert all(results[k] == [True, False, True, True] for k in range(8))
    assert sum(verifier.calls) == 32 and len(verifier.calls) < 8


def test_service_keeps_a_callers_items_in_one_call():
    """A verify_many call's items are one group: with no deadline wait
    (the staged lanes' setting) they still reach the verifier in one
    call, split only at max_batch."""
    verifier = _CountingVerifier()
    svc = gpu.BatchingVerifyService(verifier, max_batch=8, deadline_s=0.0)
    try:
        assert svc.verify_many([b"ok"] * 6 + [b"bad"]) == [True] * 6 + [False]
        assert svc.verify_many([b"ok"] * 20) == [True] * 20
    finally:
        svc.close()
    assert verifier.calls == [7, 8, 8, 4]


def test_service_deadline_raises_typed():
    gate = threading.Event()
    svc = gpu.BatchingVerifyService(_CountingVerifier(gate), deadline_s=0.0)
    try:
        with pytest.raises(gpu.VerifyDeadlineExceeded) as err:
            svc.verify_many([b"ok", b"ok"], timeout=0.2)
        assert err.value.deadline_s == 0.2
    finally:
        gate.set()
        svc.close()


def test_service_fault_fails_only_its_group():
    verifier = _CountingVerifier()
    svc = gpu.BatchingVerifyService(verifier, deadline_s=0.0)
    try:
        with pytest.raises(RuntimeError, match="device fault"):
            svc.verify_many([b"ok", b"boom"])
        assert svc.verify_many([b"ok", b"bad"]) == [True, False]
    finally:
        svc.close()


def test_service_close_drains():
    """Items submitted before close() all get verdicts, batches on the
    device included; a submit after close fails typed."""
    gate = threading.Event()
    verifier = _CountingVerifier(gate)
    svc = gpu.BatchingVerifyService(verifier, max_batch=4, deadline_s=0.0,
                                    inflight_depth=1)
    futs = [svc.submit(b"ok" if i % 3 else b"bad") for i in range(20)]
    closer = threading.Thread(target=svc.close)
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    assert [f.result(timeout=0) for f in futs] == [bool(i % 3)
                                                  for i in range(20)]
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(b"ok").result(timeout=0)


def test_gpu_verifier_rides_the_service_on_cpu():
    """The service over the GpuVerifier's CPU path: one coalesced call,
    the verifier's own verdicts."""
    items, expect = fixtures.make_block(3, n_tx=2)
    svc = gpu.BatchingVerifyService(gpu.GpuVerifier(device="cpu",
                                                    buckets=(8,)))
    try:
        assert svc.verify_many(items) == expect.tolist()
    finally:
        svc.close()
