"""The port's admission control (fabric_mod_tpu_torch/orderer/
admission.py) and its seams in Broadcast, SoloChain, RaftChain and
RaftNode, mirroring tests/test_backpressure.py and held to the
reference's fabric_mod_tpu/orderer/admission.py on the same inputs:

* token buckets and the newcomers bucket on a ManualClock: the same
  retry-afters over a seeded (clock step, client) script;
* the overload gate: the same open/close sequence over a seeded
  occupancy and latency trace, with the wall-time EWMA decay;
* the controller: the same admit / shed-by-reason decisions;
* Broadcast over a solo and over a Raft chain whose run loop is held
  (the bounded queue fills deterministically): the same admitted and
  shed (reason) sets for the same envelopes;
* the default (no setting) keeps the blocking 10,000-entry queue and no
  controller; a threaded storm against a throttled solo orderer commits
  every admitted envelope exactly once and answers every shed typed.
"""
from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import pytest

from cryptography import x509 as jx509
from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
from fabric_mod_tpu.orderer import admission as jadmission
from fabric_mod_tpu.utils.fakeclock import ManualClock as JClock

from tests._clocksteps import advance_until

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.e2e import _signer
from fabric_mod_tpu_torch.observability.metrics import default_provider
from fabric_mod_tpu_torch.orderer import admission
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

PKGS = {"port": (admission, ManualClock), "reference": (jadmission, JClock)}


# -- token buckets and the limiter --------------------------------------------

def test_token_bucket_schedule_manualclock():
    clock = ManualClock()
    lim = admission.ClientRateLimiter(rate=2.0, burst=2.0, clock=clock)
    assert lim.admit("c1") == 0.0
    assert lim.admit("c1") == 0.0
    assert lim.admit("c1") == pytest.approx(0.5)   # the real deficit
    clock.advance(0.25)
    assert lim.admit("c1") == pytest.approx(0.25)
    clock.advance(0.3)
    assert lim.admit("c1") == 0.0
    assert lim.admit("c2") == 0.0                  # its own bucket
    assert lim.throttles_by_client()["c1"] >= 2


def _limiter_script(seed, n=400):
    rng = np.random.RandomState(seed)
    return [(float(rng.choice([0.0, 0.0, 0.05, 0.3, 1.1])),
             f"c{rng.randint(6)}") for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_limiter_retry_afters_equal_the_reference(seed):
    script = _limiter_script(seed)
    waits = {}
    for pkg, (mod, clock_cls) in PKGS.items():
        clock = clock_cls()
        lim = mod.ClientRateLimiter(rate=3.0, burst=2.0, clock=clock,
                                    max_clients=4)
        got = []
        for step, client in script:
            clock.advance(step)
            got.append(lim.admit(client))
        waits[pkg] = (got, lim.throttles_by_client())
    assert waits["port"] == waits["reference"]
    assert any(w > 0 for w in waits["port"][0])      # the script throttles


def test_limiter_table_is_bounded_lru():
    clock = ManualClock()
    lim = admission.ClientRateLimiter(rate=1.0, burst=1.0, clock=clock,
                                      max_clients=2)
    for c in ("a", "b", "c"):
        assert lim.admit(c) == 0.0
    assert set(lim._buckets) == {"b", "c"}
    assert lim.admit("a") == 0.0                   # restarts full
    assert set(lim._buckets) == {"c", "a"}


def test_forged_creator_flood_cannot_mint_buckets():
    out = {}
    for pkg, (mod, clock_cls) in PKGS.items():
        lim = mod.ClientRateLimiter(rate=1.0, burst=1.0, clock=clock_cls(),
                                    max_clients=4096)
        budget = lim._newcomers.burst
        refused = [lim.admit(f"forged-{i}")
                   for i in range(int(budget) + 50)]
        out[pkg] = (refused, len(lim._buckets))
    assert out["port"] == out["reference"]
    assert sum(w > 0 for w in out["port"][0]) == 50


# -- the overload gate ---------------------------------------------------------

def test_gate_watermark_hysteresis():
    gate = admission.OverloadGate(high=0.9, low=0.6)
    assert [gate.observe(o) for o in (0.5, 0.89, 0.9, 0.7, 0.61, 0.6, 0.7)] \
        == [False, False, True, True, True, False, False]


def _gate_trace(seed, n=500):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        kind = rng.randint(3)
        if kind == 0:
            out.append(("occ", float(rng.randint(0, 101)) / 100.0))
        elif kind == 1:
            out.append(("lat", float(rng.choice([0.0, 0.05, 0.4, 2.0]))))
        else:
            out.append(("tick", float(rng.choice([0.1, 0.5, 2.0]))))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_gate_sequence_equals_the_reference(seed):
    trace = _gate_trace(seed)
    seqs = {}
    for pkg, (mod, clock_cls) in PKGS.items():
        clock = clock_cls()
        gate = mod.OverloadGate(high=0.8, low=0.3, lat_high_s=0.5,
                                clock=clock)
        seq = []
        for kind, value in trace:
            if kind == "occ":
                seq.append(gate.observe(value))
            elif kind == "lat":
                gate.note_latency(value)
            else:
                clock.advance(value)
            seq.append(round(gate.latency_ewma_s, 12))
        seqs[pkg] = seq
    assert seqs["port"] == seqs["reference"]
    opened = [v for v in seqs["port"] if isinstance(v, bool)]
    assert True in opened and False in opened


def test_latency_opened_gate_decays_shut_without_samples():
    clock = ManualClock()
    gate = admission.OverloadGate(high=0.9, low=0.6, lat_high_s=0.5,
                                  clock=clock)
    for _ in range(40):
        gate.note_latency(2.0)
    assert gate.observe(0.0) is True
    clock.advance(6.0)
    assert gate.observe(0.0) is False
    assert gate.latency_ewma_s < 0.25


# -- the controller ------------------------------------------------------------

def _controller(mod, clock, rate=None):
    lim = (mod.ClientRateLimiter(rate, burst=rate, clock=clock)
           if rate else None)
    gate = mod.OverloadGate(high=0.9, low=0.6, clock=clock)
    return mod.AdmissionController(limiter=lim, gate=gate, clock=clock)


def test_gate_state_is_per_channel():
    ctl = _controller(admission, ManualClock())
    ctl.gate_for("hot").observe(1.0)
    with pytest.raises(admission.ResourceExhaustedError):
        ctl.admit("c1", priority=False, occupancy=0.95, channel="hot")
    ctl.admit("c1", priority=False, occupancy=0.0, channel="cold")
    with pytest.raises(admission.ResourceExhaustedError):
        ctl.admit("c1", priority=False, occupancy=0.8, channel="hot")
    assert ctl.gate_for("hot").is_open and not ctl.gate_for("cold").is_open


def test_config_always_admitted_and_rate_limit_deficit():
    clock = ManualClock()
    ctl = _controller(admission, clock)
    ctl.gate.observe(1.0)
    with pytest.raises(admission.ResourceExhaustedError) as ei:
        ctl.admit("c1", priority=False, occupancy=1.0)
    assert ei.value.reason == "overloaded" and ei.value.retry_after_s > 0
    ctl.admit("c1", priority=True, occupancy=1.0)
    ctl = _controller(admission, clock, rate=1.0)
    ctl.admit("c1", priority=False, occupancy=0.0)
    with pytest.raises(admission.ResourceExhaustedError) as ei:
        ctl.admit("c1", priority=False, occupancy=0.0)
    assert ei.value.reason == "rate_limited"
    assert ei.value.retry_after_s == pytest.approx(1.0)
    ctl.admit("c1", priority=True, occupancy=0.0)


@pytest.mark.parametrize("seed", [5, 6])
def test_controller_decisions_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    script = [(f"c{rng.randint(4)}", bool(rng.randint(8) == 0),
               float(rng.randint(0, 101)) / 100.0,
               ["", "ch2"][rng.randint(2)],
               float(rng.choice([0.0, 0.1, 0.7])),
               float(rng.choice([0.001, 0.02, 0.3]))) for _ in range(300)]
    out = {}
    for pkg, (mod, clock_cls) in PKGS.items():
        clock = clock_cls()
        ctl = _controller(mod, clock, rate=2.0)
        got = []
        for client, prio, occ, ch, step, lat in script:
            clock.advance(step)
            try:
                ctl.admit(client, prio, occ, channel=ch)
                ctl.note_latency(lat, channel=ch)
                got.append("admitted")
            except mod.ResourceExhaustedError as e:
                got.append((e.reason, round(e.retry_after_s, 12)))
        out[pkg] = got
    assert out["port"] == out["reference"]
    assert {g[0] for g in out["port"] if g != "admitted"} == \
        {"overloaded", "rate_limited"}


def test_settings_build_what_the_reference_knobs_build():
    """Each setting alone turns admission on exactly as the matching
    reference knob does; none leaves it off."""
    assert not admission.AdmissionController().enabled
    assert not admission.enabled()
    ctl = admission.AdmissionController(queue_cap=8)
    assert ctl.enabled and ctl.gate is not None and not ctl.has_limiter
    assert (ctl.gate.high, ctl.gate.low) == (0.9, 0.6)
    ctl = admission.AdmissionController(rate=5.0, shed_high=2.0,
                                        shed_low=-1.0)
    assert ctl.has_limiter and ctl._limiter.burst == 10.0
    assert (ctl.gate.high, ctl.gate.low) == (1.0, 0.0)
    ctl = admission.AdmissionController(shed_lat_s=0.5, shed_high=0.5,
                                        shed_low=0.7)
    assert ctl.gate.lat_high_s == 0.5 and ctl.gate.low == 0.5


def test_shed_metrics_exported():
    ctl = _controller(admission, ManualClock())
    ctl.gate.observe(1.0)
    with pytest.raises(admission.ResourceExhaustedError):
        ctl.admit("c1", priority=False, occupancy=1.0)
    text = default_provider().render_prometheus()
    assert 'fabric_orderer_admission_sheds_total{reason="overloaded"}' in text
    assert "fabric_orderer_overload_gate_open" in text
    assert "fabric_orderer_submit_queue_occupancy" in text


# -- the chains' bounded queues -----------------------------------------------

class _StubSupport:
    @staticmethod
    def batch_timeout_s() -> float:
        return 0.2


def test_solochain_default_is_the_blocking_queue():
    from fabric_mod_tpu_torch.orderer.consensus import SoloChain
    chain = SoloChain(_StubSupport())
    assert chain._bounded is False and chain._q.maxsize == 10_000
    chain._q = queue.Queue(maxsize=1)
    chain._q.put_nowait("filler")
    landed = threading.Event()
    t = threading.Thread(target=lambda: (chain.order(
        m.Envelope(payload=b"p"), 0), landed.set()), daemon=True)
    t.start()
    assert not landed.wait(0.15)                   # blocked, not shed
    chain._q.get_nowait()
    assert landed.wait(2.0)
    t.join(timeout=2)


def _lifecycle_env():
    ext = m.ChaincodeHeaderExtension(
        chaincode_id=m.ChaincodeID(name="_lifecycle")).encode()
    ch = protoutil.make_channel_header(
        m.HeaderType.ENDORSER_TRANSACTION, "bp", extension=ext)
    sh = protoutil.make_signature_header(b"c", protoutil.new_nonce())
    return m.Envelope(payload=protoutil.make_payload(ch, sh, b"x").encode())


def test_solochain_bounded_sheds_typed_and_priority_waits():
    from fabric_mod_tpu_torch.orderer.consensus import (ChainHaltedError,
                                                        SoloChain)
    chain = SoloChain(_StubSupport(), queue_cap=2)
    env = m.Envelope(payload=b"p")
    chain.order(env, 0)
    chain.order(env, 0)
    assert chain.submit_queue_depth() == (2, 2)
    with pytest.raises(admission.ResourceExhaustedError) as ei:
        chain.order(env, 0)
    assert ei.value.reason == "queue_full"
    assert ei.value.retry_after_s == pytest.approx(0.2)
    for submit in (lambda: chain.configure(env, 0),
                   lambda: chain.order(_lifecycle_env(), 0)):
        landed = threading.Event()
        t = threading.Thread(target=lambda: (submit(), landed.set()),
                             daemon=True)
        t.start()
        assert not landed.wait(0.15)               # waits, never sheds
        chain._q.get_nowait()
        assert landed.wait(2.0)
        t.join(timeout=2)
    # a priority submit waiting on a halted chain answers typed
    outcome = []

    def waiter():
        try:
            chain.configure(env, 0)
            outcome.append("landed")
        except ChainHaltedError:
            outcome.append("halted")
    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.1)
    assert outcome == []
    chain._halted.set()
    t.join(timeout=3)
    assert outcome == ["halted"]


def test_raft_queues_count_their_drops(tmp_path):
    from fabric_mod_tpu_torch.orderer.raft import RaftNode, RaftTransport
    from fabric_mod_tpu_torch.orderer.raftchain import RaftChain, _Submit
    chain = RaftChain.__new__(RaftChain)           # the forward path only
    chain.node_id = "o0"
    chain.dropped = 0
    chain._q = queue.Queue(maxsize=1)
    chain._q.put_nowait(_Submit(b"x", False, 0))
    chain._overflow = __import__("collections").deque()
    chain._overflow_lock = threading.Lock()
    chain._PARKED_CAP = 2
    counter = admission.chain_drop_counter().with_labels("forward")
    before = counter.value
    for data in (b"a", b"b"):
        chain._on_chain_msg("o1", _Submit(data, False, 0))
    assert len(chain._overflow) == 2 and counter.value == before
    chain._on_chain_msg("o1", _Submit(b"c", False, 0))
    assert counter.value == before + 1 and chain.dropped == 1
    node = RaftNode("n1", ["n1", "n2"], RaftTransport(),
                    str(tmp_path / "n1.wal"), lambda i, d: None,
                    queue_cap=2)
    counter = admission.chain_drop_counter().with_labels("raft_msg")
    before = counter.value
    for i in range(5):
        node._on_transport_msg("n2", ("fake", i))
    assert node._q.qsize() == 2 and node.dropped == 3
    assert counter.value == before + 3
    node.stop()


# -- Broadcast over held chains: the same admitted and shed sets ---------------

CHANNEL = "admchan"
N_ENVS, QUEUE_CAP, STORM_CAP = 48, 24, 8


@pytest.fixture(scope="module")
def storm_material():
    mats = {c: fixtures.make_network_material(
        31, CHANNEL, consensus_type=c, orderers=1, max_message_count=4,
        batch_timeout="60s") for c in ("solo", "etcdraft")}
    solo = mats["solo"]
    csp = sw.SwCSP()
    signers = [_signer(csp, p) for p in
               [solo.client, *solo.peers.values(), *solo.admins.values()]]
    envs = []
    for i in range(N_ENVS):
        signer = signers[i % len(signers)]
        tx_id = f"adm-{i}"
        ch = protoutil.make_channel_header(
            m.HeaderType.ENDORSER_TRANSACTION, CHANNEL, tx_id=tx_id)
        sh = protoutil.make_signature_header(signer.serialize(),
                                             protoutil.new_nonce())
        payload = protoutil.make_payload(ch, sh, b"adm-%d" % i)
        envs.append((tx_id, protoutil.sign_envelope(payload,
                                                    signer).encode()))
    return mats, envs


def _ref_signer(pems):
    mspid, cert_pem, key_pem = pems
    return JSigner(mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem,
                   JSwCSP())


def _held_world(pkg, consensus, mat, root, clock, monkeypatch):
    """A registrar whose chain never drains its submit queue (the run
    loop waits for the halt), so occupancy moves only with admissions;
    Raft's node still elects itself on `clock`."""
    if pkg == "port":
        from fabric_mod_tpu_torch.orderer import Broadcast, Registrar
        from fabric_mod_tpu_torch.orderer.consensus import SoloChain
        from fabric_mod_tpu_torch.orderer.raftchain import RaftChain
        msgs, csp = m, sw.SwCSP()
        signer = _signer(csp, mat.orderer)
        mod = admission
    else:
        from fabric_mod_tpu.orderer import Broadcast, Registrar
        from fabric_mod_tpu.orderer.consensus import SoloChain
        from fabric_mod_tpu.orderer.raftchain import RaftChain
        from fabric_mod_tpu.protos import messages as msgs
        csp = JSwCSP()
        signer = _ref_signer(mat.orderer)
        mod = jadmission
        monkeypatch.setenv("FABRIC_MOD_TPU_SUBMIT_QUEUE", str(QUEUE_CAP))
    for cls in (SoloChain, RaftChain):
        monkeypatch.setattr(cls, "_run", lambda self: self._halted.wait())
    kwargs = {}
    if consensus == "etcdraft":
        oid = next(iter(mat.consenters))

        def factory(support):
            extra = ({"submit_queue_cap": support.submit_queue_cap}
                     if pkg == "port" else {})
            return RaftChain(oid, [oid], transport(),
                             os.path.join(str(root), f"{oid}.wal"),
                             support, clock=clock, **extra)
        if pkg == "port":
            from fabric_mod_tpu_torch.orderer.raft import RaftTransport
        else:
            from fabric_mod_tpu.orderer.raft import RaftTransport
        transport = RaftTransport
        kwargs["chain_factory"] = factory
    if pkg == "port":
        kwargs["submit_queue_cap"] = QUEUE_CAP
    registrar = Registrar(os.path.join(str(root), "reg"), signer, csp,
                          **kwargs)
    support = registrar.create_channel(msgs.Block.decode(mat.genesis))
    if consensus == "etcdraft":
        assert advance_until(clock, lambda: support.chain.is_leader)
    lim = mod.ClientRateLimiter(3.0, burst=3.0, clock=clock)
    gate = mod.OverloadGate(high=0.9, low=0.5, clock=clock)
    ctl = mod.AdmissionController(limiter=lim, gate=gate, clock=clock)
    return registrar, support, Broadcast(registrar, admission=ctl), msgs


@pytest.mark.parametrize("consensus", ["solo", "etcdraft"])
def test_admitted_and_shed_sets_equal_the_reference(storm_material,
                                                    consensus, tmp_path,
                                                    monkeypatch):
    mats, envs = storm_material
    mat = mats[consensus]
    out = {}
    for pkg, (mod, clock_cls) in PKGS.items():
        clock = clock_cls()
        with monkeypatch.context() as mp:
            registrar, support, bcast, msgs = _held_world(
                pkg, consensus, mat, tmp_path / pkg, clock, mp)
            try:
                got = []
                for tx_id, raw in envs:
                    clock.advance(0.01)
                    try:
                        bcast.submit(msgs.Envelope.decode(raw))
                        got.append((tx_id, "admitted"))
                    except mod.ResourceExhaustedError as e:
                        got.append((tx_id, e.reason))
                depth = support.chain.submit_queue_depth()
            finally:
                bcast.close()
                registrar.close()
        out[pkg] = (got, depth)
    assert out["port"] == out["reference"]
    got, depth = out["port"]
    reasons = {r for _t, r in got}
    assert {"admitted", "overloaded", "rate_limited"} <= reasons
    assert depth[0] <= QUEUE_CAP and depth[1] == QUEUE_CAP


def test_default_broadcast_has_no_admission(storm_material, tmp_path):
    from fabric_mod_tpu_torch.orderer import Broadcast, Registrar
    mats, _envs = storm_material
    csp = sw.SwCSP()
    registrar = Registrar(str(tmp_path), _signer(csp, mats["solo"].orderer),
                          csp)
    try:
        support = registrar.create_channel(
            m.Block.decode(mats["solo"].genesis))
        assert support.chain._bounded is False
        assert support.chain.submit_queue_depth()[1] == 10_000
        assert Broadcast(registrar).admission is None
        assert Broadcast(registrar, admission=admission.AdmissionController(
            shed_high=0.5)).admission is None
        assert Broadcast(registrar, admission=admission.AdmissionController(
            rate=1.0)).admission is not None
    finally:
        registrar.close()


def test_storm_invariant_inprocess(storm_material, tmp_path):
    """A many-client burst against a throttled solo orderer with the
    gated stack on: every admitted envelope commits exactly once, every
    shed is typed, the queue stays bounded."""
    from fabric_mod_tpu_torch.orderer import Broadcast, Registrar
    mats, envs = storm_material
    mat = fixtures.make_network_material(
        31, CHANNEL, max_message_count=4, batch_timeout="50ms")
    csp = sw.SwCSP()
    registrar = Registrar(str(tmp_path), _signer(csp, mat.orderer), csp,
                          submit_queue_cap=STORM_CAP)
    try:
        support = registrar.create_channel(m.Block.decode(mat.genesis))
        orig = support.writer.write_block

        def slow_write(block, *a, **kw):
            time.sleep(0.03)                       # the controlled overload
            return orig(block, *a, **kw)
        support.writer.write_block = slow_write
        bcast = Broadcast(registrar, admission=admission.AdmissionController(
            queue_cap=STORM_CAP))
        admitted, shed, errors = [], [], []
        lock = threading.Lock()
        depth = [0]

        def client_main(mine):
            acc, sh, errs = [], [], []
            for tx_id, raw in mine:
                try:
                    bcast.submit(m.Envelope.decode(raw))
                    acc.append(tx_id)
                except admission.ResourceExhaustedError as e:
                    sh.append((tx_id, e.reason))
                except Exception as e:             # fails the test below
                    errs.append(repr(e))
                depth[0] = max(depth[0],
                               support.chain.submit_queue_depth()[0])
            with lock:
                admitted.extend(acc)
                shed.extend(sh)
                errors.extend(errs)
        threads = [threading.Thread(target=client_main,
                                    args=(envs[i::6],), daemon=True)
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert errors == []
        assert admitted and shed
        assert {r for _t, r in shed} <= {"queue_full", "overloaded"}
        assert depth[0] <= STORM_CAP
        store = support.store
        deadline = time.time() + 60
        while time.time() < deadline:
            if sum(len(store.get_block_by_number(i).data.data)
                   for i in range(1, store.height)) >= len(admitted):
                break
            time.sleep(0.02)
        committed = [protoutil.envelope_channel_header(env).tx_id
                     for n in range(1, store.height)
                     for env in protoutil.get_envelopes(
                         store.get_block_by_number(n))]
        assert sorted(committed) == sorted(admitted)
        bcast.close()
    finally:
        registrar.close()
