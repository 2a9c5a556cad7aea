"""The operations server, logging specs and diagnostics in the port
(fabric_mod_tpu_torch/observability/opsserver.py, logging.py, diag.py),
with the commit pipe's health seam and the participation REST surface,
mirroring tests/test_observability.py's server, logging and health cases
and held to the reference's:

* every route: /metrics, /healthz, /logspec GET and PUT, /version,
  /debug/threads, /debug/pprof and /debug/profile, /trace and /flight
  over the armed tracer, the participation routes, 404 elsewhere;
* the level each logging spec sets, by logger suffix, equal to the
  reference's;
* /healthz flipped by a poisoned commit pipe (per-instance keys), and
  back once the channel discards the pipe;
* the participation answers (status codes and JSON bodies) equal to the
  reference's `handle` on the same registrar actions;
* HTTPS with a client certificate from the port's own CA, a client
  without one refused;
* the SIGUSR1 thread dump installs from the main thread.
"""
import base64
import faulthandler
import json
import logging
import signal
import ssl
import threading
import time
import urllib.error
import urllib.request

import pytest

from fabric_mod_tpu_torch import e2e
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.observability import (HealthRegistry, MetricOpts,
                                                MetricsProvider,
                                                OperationsServer,
                                                activate_spec,
                                                default_health, diag,
                                                get_logger, init_logging,
                                                tracing)
from fabric_mod_tpu_torch.observability.logging import current_spec
from fabric_mod_tpu_torch.orderer.participation import ChannelParticipation
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
from fabric_mod_tpu_torch.utils import fixtures

SPECS = ("info", "peer=debug:warn", "gossip=warn:ledger=debug:info",
         "debug", "peer.commitpipe=error:peer=info:fatal",
         "orderer=warning:error")
SUFFIXES = ("", "peer", "peer.commitpipe", "gossip", "ledger", "orderer",
            "msp")


def _get(url, **kw):
    """(status, body bytes) — an HTTP error status too."""
    try:
        with urllib.request.urlopen(url, timeout=30, **kw) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _request(url, method, body=b""):
    req = urllib.request.Request(url, data=body or None, method=method)
    return _get(req)


@pytest.fixture()
def server():
    provider = MetricsProvider()
    provider.new_gauge(MetricOpts("node", "", "up")).set(1)
    health = HealthRegistry()
    health.register("alwaysok", lambda: None)
    srv = OperationsServer(provider=provider, health=health)
    srv.start()
    yield srv, health, "http://%s:%d" % srv.addr
    srv.stop()
    activate_spec("info")


def test_every_plain_route(server):
    srv, health, base = server
    code, body = _get(base + "/metrics")
    assert code == 200 and b"node_up 1" in body
    code, body = _get(base + "/healthz")
    assert code == 200 and json.loads(body) == {"status": "OK",
                                                "failed_checks": {}}
    assert json.loads(_get(base + "/version")[1]) == {"Version": "0.3.0"}
    assert _request(base + "/logspec", "PUT", json.dumps(
        {"spec": "ledger=debug:info"}).encode())[0] == 204
    assert json.loads(_get(base + "/logspec")[1]) == {
        "spec": "ledger=debug:info"}
    assert current_spec() == "ledger=debug:info"
    assert _request(base + "/logspec", "PUT", json.dumps(
        {"spec": "ledger=loud"}).encode())[0] == 400
    assert current_spec() == "ledger=debug:info"
    code, body = _get(base + "/debug/threads")
    assert code == 200 and b"MainThread" in body and \
        b"opsserver-http" in body
    for route in ("/debug/profile?seconds=0.2", "/debug/pprof?seconds=0.2"):
        code, body = _get(base + route)
        assert code == 200 and b"collapsed stacks" in body
        lines = [ln for ln in body.decode().splitlines()
                 if ln and not ln.startswith("#")]
        assert lines and all(ln.rsplit(" ", 1)[1].isdigit()
                             for ln in lines)
    assert _get(base + "/debug/profile?seconds=x")[0] == 400
    assert _get(base + "/nowhere")[0] == 404
    assert _request(base + "/metrics", "POST", b"x")[0] == 404
    assert _request(base + "/metrics", "DELETE")[0] == 404
    assert _get(base + "/participation/v1/channels")[0] == 404
    health.register("down", lambda: (_ for _ in ()).throw(
        RuntimeError("broken")))
    code, body = _get(base + "/healthz")
    assert code == 503 and json.loads(body) == {
        "status": "Service Unavailable", "failed_checks": {"down": "broken"}}


def test_trace_and_flight_serve_the_armed_tracer(server):
    _srv, _health, base = server
    tracing.recorder().reset()
    try:
        with tracing.active():
            tl = tracing.start_timeline("deliver", 7)
            with tracing.timeline_scope(tl):
                with tracing.span("ledger_write", block=7):
                    pass
            tracing.finish_timeline(tl)
            body = json.loads(_get(base + "/trace?limit=10")[1])
        assert body["armed"] is True
        assert [s["name"] for s in body["spans"]] == ["ledger_write"]
        tid = body["spans"][0]["trace_id"]
        assert json.loads(_get(base + f"/trace?trace_id={tid}")[1])[
            "spans"] == body["spans"]
        assert json.loads(_get(base + "/trace?trace_id=none")[1])[
            "spans"] == []
        flight = json.loads(_get(base + "/flight")[1])
        assert flight == json.loads(json.dumps(tracing.flight_dump()))
        assert [t["block"] for t in flight["timelines"]] == [7]
    finally:
        tracing.recorder().reset()


@pytest.mark.parametrize("spec", SPECS)
def test_logspec_levels_equal_the_reference(spec):
    from fabric_mod_tpu.observability import logging as jlog
    try:
        activate_spec(spec)
        jlog.activate_spec(spec)
        for suffix in SUFFIXES:
            mine = get_logger(suffix)
            theirs = jlog.get_logger(suffix)
            assert (mine.level, mine.getEffectiveLevel()) == \
                (theirs.level, theirs.getEffectiveLevel()), suffix
    finally:
        activate_spec("info")
        jlog.activate_spec("info")
    with pytest.raises(ValueError):
        activate_spec("peer=loud")
    assert current_spec() == "info"


def test_counting_handler_counts_by_level():
    provider = MetricsProvider()
    root = logging.getLogger("fabric_mod_tpu_torch")
    before = list(root.handlers)
    init_logging(provider, spec="info")
    try:
        log = get_logger("ops.test")
        log.warning("one")
        log.debug("filtered out at info")
        text = provider.render_prometheus()
        assert 'logging_entries_total{level="warning"} 1.0' in text
        assert "debug" not in text
    finally:
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
        activate_spec("info")


class _Boom:
    """A commit target whose staging always raises."""

    class ledger:
        height = 0

    def stage_block(self, block):
        raise RuntimeError("staged boom")

    def commit_staged(self, staged):
        raise AssertionError("unreached")


class _Block:
    class header:
        number = 0


def _mine(failures, prefix):
    return [v for k, v in failures.items() if k.startswith(prefix)]


def test_a_poisoned_pipe_flips_the_default_healthz():
    reg = default_health()
    srv = OperationsServer(provider=MetricsProvider())
    srv.start()
    base = "http://%s:%d" % srv.addr
    pipe = PipelinedCommitter(_Boom(), depth=1, consumer="opstest")
    healthy = PipelinedCommitter(_Boom(), depth=1, consumer="opstest")
    try:
        pipe.submit(_Block())
        with pytest.raises(RuntimeError, match="staged boom"):
            pipe.flush(30)
        code, body = _get(base + "/healthz")
        assert code == 503
        # the healthy sibling with the same label masks nothing
        assert [v for v in _mine(json.loads(body)["failed_checks"],
                                 "commitpipe[opstest#")
                if "poisoned" in v and "staged boom" in v]
        healthy.close()
        pipe.close()             # a discarded pipe leaves the registry
        assert not _mine(reg.status()[1], "commitpipe[opstest#")
    finally:
        pipe.close()
        healthy.close()
        srv.stop()


def test_channel_discarding_a_poisoned_pipe_heals_healthz(tmp_path):
    """A planted staging error poisons the channel's shared pipe: 503;
    the channel's next commit_pipeline() discards it and commits on a
    new one: the registry is back to what it was."""
    before = dict(default_health().status()[1])
    net = e2e.Network(str(tmp_path), material=fixtures.make_network_material(
        81, max_message_count=2, batch_timeout="10s"),
        verifier=sw.SwVerifier(), pipeline_depth=2)
    srv = OperationsServer(provider=MetricsProvider())
    srv.start()
    base = "http://%s:%d" % srv.addr
    try:
        net.invoke([b"put", b"a", b"1"])
        net.invoke([b"put", b"b", b"2"])
        deadline = time.monotonic() + 30
        while net.support.store.height < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        block = net.support.store.get_block_by_number(1)
        channel = net.channel

        def planted(_block):
            del channel.stage_block
            raise RuntimeError("planted stage error")
        channel.stage_block = planted
        pipe = channel.commit_pipeline()
        pipe.submit(block)
        with pytest.raises(RuntimeError, match="planted"):
            pipe.flush(30)
        code, body = _get(base + "/healthz")
        assert code == 503 and [
            v for v in _mine(json.loads(body)["failed_checks"],
                             "commitpipe[channel#") if "planted" in v]
        assert list(channel.store_block(block)) == [0, 0]
        assert channel.commit_pipeline() is not pipe and pipe.closed
        code, body = _get(base + "/healthz")
        assert json.loads(body)["failed_checks"] == before
        assert code == (200 if not before else 503)
    finally:
        srv.stop()
        net.close()


def _participation_world(tmp_path, seed):
    mat = fixtures.make_network_material(seed, "opschan")
    csp = sw.SwCSP()
    reg = Registrar(str(tmp_path / "port"), e2e._signer(csp, mat.orderer),
                    csp)
    return mat, reg


def _reference_registrar(tmp_path, mat):
    from cryptography import x509 as jx509
    from fabric_mod_tpu.bccsp.sw import SwCSP as JSwCSP
    from fabric_mod_tpu.msp.identities import SigningIdentity as JSigner
    from fabric_mod_tpu.orderer.registrar import Registrar as JRegistrar
    mspid, cert_pem, key_pem = mat.orderer
    jcsp = JSwCSP()
    return JRegistrar(str(tmp_path / "ref"), JSigner(
        mspid, jx509.load_pem_x509_certificate(cert_pem), key_pem, jcsp),
        jcsp)


def _actions(genesis_b64):
    join = json.dumps({"config_block": genesis_b64}).encode()
    return [
        ("GET", "/participation/v1/channels", b""),
        ("POST", "/participation/v1/channels", join),
        ("GET", "/participation/v1/channels", b""),
        ("GET", "/participation/v1/channels/opschan", b""),
        ("POST", "/participation/v1/channels", join),
        ("POST", "/participation/v1/channels", b'{"config_block": "!!"}'),
        ("POST", "/participation/v1/channels", b"not json"),
        ("POST", "/participation/v1/channels", json.dumps(
            {"config_block": genesis_b64, "follower": True}).encode()),
        ("GET", "/participation/v1/channels/nochan", b""),
        ("DELETE", "/participation/v1/channels", b""),
        ("GET", "/participation/v2/channels", b""),
        ("DELETE", "/participation/v1/channels/opschan", b""),
        ("GET", "/participation/v1/channels", b""),
    ]


def test_participation_rest_equals_the_reference(tmp_path):
    from fabric_mod_tpu.orderer.participation import \
        ChannelParticipation as JParticipation
    mat, reg = _participation_world(tmp_path, 82)
    jreg = _reference_registrar(tmp_path, mat)
    srv = OperationsServer(provider=MetricsProvider(),
                           participation=ChannelParticipation(reg))
    srv.start()
    base = "http://%s:%d" % srv.addr
    jpart = JParticipation(jreg)
    try:
        codes = []
        for method, path, body in _actions(
                base64.b64encode(mat.genesis).decode()):
            code, raw = _request(base + path, method, body)
            got = [code, json.loads(raw) if raw else None]
            want = jpart.handle(method, path, body)
            assert got == json.loads(json.dumps(want)), (method, path)
            codes.append(code)
        assert codes == [200, 201, 200, 200, 400, 400, 400, 400, 400, 405,
                         404, 204, 200]
        assert reg.channel_ids() == [] and jreg.get_chain("opschan") is None
    finally:
        srv.stop()
        reg.close()
        jreg.close()


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_https_requires_a_client_certificate_of_the_port_ca(tmp_path):
    ca = calib.CA("ca.ops", "OpsOrg", seed=b"ops", now=fixtures.CERT_EPOCH)
    scert, skey = ca.issue("localhost", "OpsOrg", ous=["server"])
    ccert, ckey = ca.issue("operator", "OpsOrg", ous=["client"])
    stranger = calib.CA("ca.other", "Other", seed=b"other",
                        now=fixtures.CERT_EPOCH)
    xcert, xkey = stranger.issue("operator", "Other", ous=["client"])
    ca_path = _write(tmp_path, "ca.pem", ca.cert_pem())
    srv = OperationsServer(provider=MetricsProvider(),
                           health=HealthRegistry(), tls={
        "cert": _write(tmp_path, "s.pem", scert.pem()),
        "key": _write(tmp_path, "s.key", calib.key_pem(skey)),
        "client_ca": ca_path})
    srv.start()
    url = "https://%s:%d/healthz" % srv.addr

    def context(cert=None, key=None):
        ctx = ssl.create_default_context(cafile=ca_path)
        ctx.check_hostname = False
        if cert is not None:
            ctx.load_cert_chain(_write(tmp_path, "c.pem", cert.pem()),
                                _write(tmp_path, "c.key",
                                       calib.key_pem(key)))
        return ctx
    try:
        code, body = _get(url, context=context(ccert, ckey))
        assert code == 200 and json.loads(body) == {"status": "OK",
                                                    "failed_checks": {}}
        for ctx in (context(), context(xcert, xkey)):
            with pytest.raises((ssl.SSLError, urllib.error.URLError,
                                ConnectionError)):
                _get(url, context=ctx)
    finally:
        srv.stop()


def test_thread_dump_and_signal_install():
    text = diag.dump_threads()
    assert f"--- thread {threading.current_thread().name}" in text
    assert threading.current_thread() is threading.main_thread()
    diag.install_signal_dump(signal.SIGUSR1)
    try:
        assert faulthandler.unregister(signal.SIGUSR1)
    finally:
        faulthandler.unregister(signal.SIGUSR1)
