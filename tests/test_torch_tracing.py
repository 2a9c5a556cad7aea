"""The port's tracer (fabric_mod_tpu_torch/observability/tracing.py)
against the reference's (fabric_mod_tpu/observability/tracing.py),
mirroring tests/test_tracing.py.

1. Disarmed is a behavioural no-op: `span()` returns one shared no-op
   singleton, nothing lands in the recorder, and a commit through the
   pipelined committer gives the same txflags and state fingerprint
   armed and disarmed (tracing is a pure observer).
2. Context crosses the real async seams: the BatchingVerifyService's
   submit -> flusher -> resolver handoffs, and the commit pipe's stage
   -> commit handoff (the StagedBlock carries its timeline).
3. The same blocks committed through both packages' traced pipelined
   committers give every block timeline the same span names.
4. The rings are bounded, the Chrome export is schema-valid, and every
   `tracing.span("...")` literal in the port is declared in
   observability/spannames.py, every declared name used by a seam.
5. The device lens on the CPU plain path: one armed GpuVerifier dispatch
   writes a trace, the window is one-shot, the build counter is
   reported.
"""
import ast
import json
import pathlib
import time

import pytest
import torch

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.observability import spannames, tracing
from fabric_mod_tpu_torch.observability.metrics import default_provider
from fabric_mod_tpu_torch.ops import _build
from fabric_mod_tpu_torch.peer.commitpipe import (PipelinedCommitter,
                                                  ValidatorCommitTarget)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

PORT = pathlib.Path(__file__).resolve().parents[1] / "fabric_mod_tpu_torch"
N_BLOCKS, N_TX = 2, 16
# the sub-stages every block of a pipelined commit must carry
COMMIT_SUBSTAGES = {"unpack", "body_decode", "device_dispatch",
                    "verdict_await", "policy_finish", "mvcc", "mvcc_vector",
                    "ledger_write"}


@pytest.fixture(autouse=True)
def _clean_recorder():
    prev = tracing.armed()
    tracing.enable(False)
    tracing.recorder().reset()
    yield
    tracing.enable(prev)
    tracing.recorder().reset()


# -- 1. disarmed: the zero-cost contract --------------------------------------

def test_disarmed_span_is_shared_noop_singleton():
    s1 = tracing.span("a", block=1)
    s2 = tracing.span("b")
    assert s1 is s2
    with s1 as got:
        assert got is s1
        got.set(anything="goes")
    assert s1.ctx is None
    assert tracing.recorder().span_count() == 0
    assert tracing.current_ctx() is None
    assert tracing.start_timeline("c", 0) is None
    tracing.finish_timeline(None)
    with tracing.timeline_scope(None):
        pass
    assert tracing.recorder().timeline_count() == 0
    tracing.note_event("k", "d")
    tracing.auto_dump("r")
    assert tracing.recorder().events() == []
    assert tracing.recorder().dumps() == []
    assert tracing.inject() is None
    assert tracing.device_profile_capture("/nonexistent") is None


def test_armed_span_nesting_parents_and_totals():
    with tracing.active():
        with tracing.span("parent", block=3) as p:
            assert tracing.current_ctx() == p.ctx
            with tracing.span("child") as c:
                assert c.trace_id == p.trace_id
                assert c.parent_id == p.span_id
        assert tracing.current_ctx() is None
        with tracing.span("grand") as g:
            carrier = g.ctx
        with tracing.span("adopted", parent=carrier) as a:
            assert a.trace_id == carrier.trace_id
            assert a.parent_id == carrier.span_id
    spans = tracing.recorder().recent_spans()
    assert [s["name"] for s in spans] == ["child", "parent", "grand",
                                          "adopted"]
    assert spans[0]["parent_id"] == spans[1]["span_id"]
    assert spans[1]["attrs"] == {"block": 3}
    totals = tracing.substage_totals()
    assert totals["parent"]["count"] == 1
    # the substage histogram in the exposition
    text = default_provider().render_prometheus()
    assert 'fabric_trace_substage_seconds_count{stage="parent"}' in text


def test_manual_clock_drives_span_and_timeline_durations():
    clock = ManualClock(100.0)
    tracing.set_clock(clock.monotonic)
    try:
        with tracing.active():
            tl = tracing.start_timeline("sync", 5)
            with tracing.timeline_scope(tl):
                with tracing.span("timed"):
                    clock.advance(2.5)
            clock.advance(0.5)
            tracing.finish_timeline(tl)
            tracing.finish_timeline(tl)      # idempotent
        got = tracing.recorder().recent_spans()[-1]
        assert got["dur"] == pytest.approx(2.5)
        assert got["ts"] == pytest.approx(100.0)
        (t,) = tracing.recorder().timelines()
        assert t["dur"] == pytest.approx(3.0)
        assert t["subs"] == [{"name": "timed", "ts": 100.0, "dur": 2.5}]
    finally:
        tracing.set_clock(time.time)


def test_inject_extract_roundtrip_and_malformed():
    with tracing.active():
        with tracing.span("root") as r:
            md = tracing.inject()
            assert md == [(tracing.TRACE_METADATA_KEY,
                           f"{r.trace_id}-{r.span_id}")]
            assert tracing.extract(md) == r.ctx
    assert tracing.extract(None) is None
    assert tracing.extract([("other", "x")]) is None
    assert tracing.extract([(tracing.TRACE_METADATA_KEY, "garbage")]) \
        is None
    assert tracing.extract(object()) is None


# -- 2. propagation across the async seams ------------------------------------

def test_verify_service_links_flush_and_resolve_under_the_submitter():
    items, expect = fixtures.make_verify_items(4, n_keys=2, seed=b"trace")
    svc = gpu.BatchingVerifyService(sw.SwVerifier(), deadline_s=0.001)
    try:
        with tracing.active():
            with tracing.span("client_submit") as root:
                got = svc.verify_many(items, timeout=60)
        assert list(got) == expect
        spans = tracing.recorder().recent_spans()
        flushes = [s for s in spans if s["name"] == "verify.flush"]
        resolves = [s for s in spans if s["name"] == "verify.resolve"]
        assert flushes and resolves
        assert all(s["trace_id"] == root.trace_id
                   and s["parent_id"] == root.span_id for s in flushes)
        flush_ids = {s["span_id"] for s in flushes}
        assert all(s["trace_id"] == root.trace_id
                   and s["parent_id"] in flush_ids for s in resolves)
    finally:
        svc.close()


def test_verify_service_disarmed_untraced():
    items, expect = fixtures.make_verify_items(3, n_keys=2, seed=b"off")
    svc = gpu.BatchingVerifyService(sw.SwVerifier(), deadline_s=0.001)
    try:
        assert list(svc.verify_many(items, timeout=60)) == expect
    finally:
        svc.close()
    assert tracing.recorder().span_count() == 0


# -- the commit path: port against itself and against the reference ----------

def _reference_world_pems():
    from fabric_mod_tpu.msp import ca as jca
    from fabric_mod_tpu.policy import from_string
    from fabric_mod_tpu.protos import messages as jm
    cas, signers = {}, {}
    for org in ("Org1", "Org2", "Org3"):
        cas[org] = jca.CA(f"ca.{org.lower()}", org)
        cert, key = cas[org].issue(f"peer0.{org.lower()}", org, ous=["peer"])
        signers[org] = (org, jca.cert_pem(cert), jca.key_pem(key))
    cert, key = cas["Org1"].issue("client@org1", "Org1", ous=["client"])
    signers["client"] = ("Org1", jca.cert_pem(cert), jca.key_pem(key))
    policy = jm.ApplicationPolicy(signature_policy=from_string(
        fixtures.ENDORSEMENT_POLICY)).encode()
    return {o: ca.cert_pem() for o, ca in cas.items()}, signers, policy


@pytest.fixture(scope="module")
def commit_case():
    from fabric_mod_tpu_torch import convert
    ca_pems, signers, policy = _reference_world_pems()
    world = convert.world_from_reference(ca_pems, signers, policy)
    blocks, expected = fixtures.make_commit_blocks(world, N_BLOCKS, N_TX)
    return ca_pems, policy, world, blocks, expected


def _port_pipe(world, blocks):
    """Commit `blocks` through the port's pipelined committer; (flags,
    fingerprint)."""
    committer = world.committer(sw.SwVerifier())
    pipe = PipelinedCommitter(ValidatorCommitTarget(
        committer.validator, committer.ledger), depth=2)
    decoded = [m.Block.decode(raw) for raw in blocks]
    try:
        for block in decoded:
            pipe.submit(block)
        assert pipe.flush(timeout_s=120)
    finally:
        pipe.close()
    assert pipe.error is None
    flags = [list(protoutil.block_txflags(b)) for b in decoded]
    return flags, committer.ledger.state_fingerprint()


def _reference_pipe(ca_pems, policy, blocks, root):
    """The same blocks through the reference's traced pipelined
    committer (vector MVCC on, as the port always runs it); (flags,
    fingerprint, block timelines)."""
    from fabric_mod_tpu.bccsp.sw import SwCSP
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.ledger import KvLedger
    from fabric_mod_tpu.msp.cache import CachedMsp
    from fabric_mod_tpu.msp.identities import deserialize_cert
    from fabric_mod_tpu.msp.mspimpl import Msp, MspManager
    from fabric_mod_tpu.observability import tracing as jtracing
    from fabric_mod_tpu.peer import (PipelinedCommitter as JPipe,
                                     TxValidator, ValidationInfoProvider,
                                     ValidatorCommitTarget as JTarget)
    from fabric_mod_tpu.peer.txvalidator import VALIDATION_PARAMETER
    from fabric_mod_tpu.policy import ApplicationPolicyEvaluator
    from fabric_mod_tpu.protos import messages as jm
    from fabric_mod_tpu.protos import protoutil as jprotoutil
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
        jtracing.recorder().reset()
        decoded = [jm.Block.decode(raw) for raw in blocks]
        with jtracing.active():
            pipe = JPipe(JTarget(validator, led), depth=2)
            for block in decoded:
                pipe.submit(block)
            pipe.flush()
            pipe.close()
        timelines = jtracing.recorder().timelines()
        jtracing.recorder().reset()
        flags = [list(jprotoutil.block_txflags(b)) for b in decoded]
        fp = led.state_fingerprint()
        led.close()
    return flags, fp, timelines


def _names_by_block(timelines):
    return {t["block"]: sorted(s["name"] for s in t["subs"])
            for t in timelines}


def test_tracing_is_a_pure_observer_of_the_commit(commit_case):
    _ca, _policy, world, blocks, expected = commit_case
    off_flags, off_fp = _port_pipe(world, blocks)
    assert off_flags == expected
    assert tracing.recorder().span_count() == 0
    assert tracing.recorder().timeline_count() == 0
    with tracing.active():
        on_flags, on_fp = _port_pipe(world, blocks)
    assert (on_flags, on_fp) == (off_flags, off_fp)
    tls = tracing.recorder().timelines()
    assert [t["block"] for t in tls] == list(range(N_BLOCKS))
    assert {t["consumer"] for t in tls} == {"adhoc"}
    for t in tls:
        # the stage side's and the commit side's sub-stages in ONE
        # timeline: the StagedBlock carried it across the threads
        assert COMMIT_SUBSTAGES <= {s["name"] for s in t["subs"]}, t
    totals = tracing.substage_totals()
    for name in COMMIT_SUBSTAGES:
        assert totals[name]["count"] >= N_BLOCKS


def test_block_timelines_name_the_same_spans_as_the_reference(
        commit_case, tmp_path):
    ca_pems, policy, world, blocks, expected = commit_case
    ref_flags, ref_fp, ref_tls = _reference_pipe(ca_pems, policy, blocks,
                                                 tmp_path / "ref")
    with tracing.active():
        port_flags, port_fp = _port_pipe(world, blocks)
    port_tls = tracing.recorder().timelines()
    assert port_flags == ref_flags == expected
    assert port_fp == ref_fp
    assert len(ref_tls) == len(port_tls) == N_BLOCKS
    assert _names_by_block(port_tls) == _names_by_block(ref_tls)


def test_sync_committer_records_a_sync_timeline(commit_case):
    _ca, _policy, world, blocks, expected = commit_case
    committer = world.committer(sw.SwVerifier())
    with tracing.active():
        assert committer.store_block(m.Block.decode(blocks[0])) == \
            expected[0]
    (t,) = tracing.recorder().timelines()
    assert t["consumer"] == "sync" and t["block"] == 0
    assert COMMIT_SUBSTAGES <= {s["name"] for s in t["subs"]}


def test_run_pipeline_reports_stage_attribution_armed_only():
    stats = {}
    with tracing.active():
        rate = e2e.run_pipeline(8, verifier=sw.SwVerifier(), stats=stats)
    assert rate > 0
    attribution = stats["stage_attribution"]
    for name in ("recv", "unpack", "verdict_await", "policy_finish", "mvcc",
                 "ledger_write", "broadcast.submit"):
        assert attribution[name] > 0, name
    names = {t["consumer"] for t in tracing.recorder().timelines()}
    assert names == {"deliver"}
    tracing.recorder().reset()
    stats = {}
    e2e.run_pipeline(8, verifier=sw.SwVerifier(), stats=stats)
    assert "stage_attribution" not in stats
    assert tracing.recorder().span_count() == 0


# -- 3. the recorder, the export and the span registry -------------------------

def test_flight_and_span_rings_are_bounded():
    rec = tracing.recorder()
    assert (rec.span_ring, rec.flight_ring) == (tracing.SPAN_RING,
                                                tracing.FLIGHT_RING)
    small = tracing.configure_rings(span_ring=16, flight_ring=8)
    try:
        with tracing.active():
            for i in range(8 * 3):
                tl = tracing.start_timeline("load", i)
                with tracing.timeline_scope(tl):
                    with tracing.span("unpack"):
                        pass
                tracing.finish_timeline(tl)
        assert small.timeline_count() == 8
        got = small.timelines()
        assert got[-1]["block"] == 23 and got[0]["block"] == 16
        assert small.span_count() == 16
        assert small.totals()["unpack"]["count"] == 24
    finally:
        tracing.configure_rings()
    assert tracing.configure_rings(span_ring=1, flight_ring=1).span_ring == 8
    tracing.configure_rings()


def test_auto_dump_events_and_flight_text():
    with tracing.active():
        tl = tracing.start_timeline("deliver", 42)
        with tracing.timeline_scope(tl):
            with tracing.span("mvcc"):
                pass
        tracing.finish_timeline(tl)
        tracing.note_event("admission_shed", "queue_full")
        tracing.auto_dump("first")
        tracing.auto_dump("rate-limited")      # inside 5 s: suppressed
        text = tracing.flight_text()
        dump = tracing.flight_dump()
    assert "block 42" in text and "mvcc=" in text
    assert "admission_shed:queue_full" in text
    dumps = tracing.recorder().dumps()
    assert [d["reason"] for d in dumps] == ["first"]
    assert dumps[0]["timelines"][0]["block"] == 42
    kinds = [e["kind"] for e in tracing.recorder().events()]
    assert kinds == ["admission_shed", "dump"]
    assert dump["armed"] and dump["totals"]["mvcc"]["count"] == 1


def test_chrome_trace_export_schema(tmp_path):
    with tracing.active():
        with tracing.span("unpack", block=1):
            with tracing.span("device_dispatch", items=8):
                pass
    out = tmp_path / "trace.json"
    n = tracing.export_chrome_trace(str(out))
    doc = json.loads(out.read_text())
    events = doc["traceEvents"]
    assert n == len(events) >= 4
    for ev in events:
        assert {"ph", "pid", "tid", "name"} <= set(ev)
        assert ev["ph"] in ("X", "b", "e", "M")
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    begins = [e for e in events if e["ph"] == "b"]
    ends = [e for e in events if e["ph"] == "e"]
    assert len(begins) == len(ends) == 1
    assert begins[0]["id"] == ends[0]["id"]
    assert begins[0]["cat"] == "device"
    assert doc["otherData"]["kernel_builds"] == _build.build_count()
    assert doc["otherData"]["substage_totals"]["unpack"]["count"] == 1


def _span_literals():
    """{span name: [file:line]} of every tracing.span("<literal>") in the
    port."""
    found = {}
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "span" and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "tracing":
                assert node.args and isinstance(node.args[0], ast.Constant), \
                    f"{path}:{node.lineno}: span name is not a literal"
                found.setdefault(node.args[0].value, []).append(
                    f"{path.name}:{node.lineno}")
    return found


def test_every_span_literal_is_declared_and_every_declaration_used():
    found = _span_literals()
    undeclared = {n: w for n, w in found.items()
                  if not spannames.is_declared(n)}
    assert not undeclared
    assert set(found) == spannames.DECLARED_SPANS
    # the port's set is the reference's, the broadcast server's span too
    from fabric_mod_tpu.observability import spannames as jspannames
    assert spannames.DECLARED_SPANS == jspannames.DECLARED_SPANS


# -- 4. the device lens on the CPU plain path ---------------------------------

def test_device_lens_writes_a_trace_once(tmp_path, monkeypatch):
    """One armed dispatch on the CPU plain path runs inside the window
    and leaves a Chrome trace; the window is one-shot.  The plain
    ladder's ~10^5 torch ops would make a 600 MB trace on the CPU, so
    the lensed call replays the ladder's outputs from the same call made
    disarmed first (the marshal, the plain prologue and epilogue still
    run in the window)."""
    from fabric_mod_tpu_torch.ops import p256_cuda
    torch.set_num_threads(1)
    items, expect = fixtures.make_verify_items(4, n_keys=2, seed=b"lens")
    verifier = gpu.GpuVerifier(device="cpu", buckets=(8,), cache_size=0,
                               profile_dir=str(tmp_path / "lens"))
    real, seen = p256_cuda.ladder_words, {}

    def record(*args, **kwargs):
        seen["args"] = [a.clone() for a in args if torch.is_tensor(a)]
        seen["out"] = real(*args, **kwargs)
        return seen["out"]

    def replay(*args, **kwargs):
        got = [a for a in args if torch.is_tensor(a)]
        assert all(torch.equal(a, b) for a, b in zip(got, seen["args"]))
        return seen["out"]
    tracing.rearm_device_profile()
    try:
        # disarmed: no window, even with a directory
        monkeypatch.setattr(p256_cuda, "ladder_words", record)
        assert list(verifier.verify_many(items)) == expect
        assert tracing.last_lens() is None
        assert not (tmp_path / "lens").exists()
        monkeypatch.setattr(p256_cuda, "ladder_words", replay)
        builds = _build.build_count()
        with tracing.active():
            assert list(verifier.verify_many(items)) == expect
            lens = tracing.last_lens()
            assert lens is not None and lens.path is not None
            # one-shot: no second window in this process
            assert tracing.device_profile_capture(
                str(tmp_path / "again")) is None
            events = tracing.recorder().events()
    finally:
        tracing.rearm_device_profile()
    doc = json.loads(pathlib.Path(lens.path).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
    assert list((tmp_path / "lens").iterdir()) == [pathlib.Path(lens.path)]
    assert [(e["kind"], e["detail"]) for e in events] == [
        ("device_profile", lens.path)]
    # the CPU plain path launches no hand-written kernel and the trace
    # holds none: the gate the card's run holds with counts > 0
    assert lens.launches == {} and lens.trace_kernels == {}
    assert tracing.compile_count() == _build.build_count() == builds
