"""The port's RPC layer (fabric_mod_tpu_torch/comm/: the wire, the
server and client wrappers, TLS material) against the reference's gRPC
one (fabric_mod_tpu/comm/, grpcio).

The same handlers are registered on a reference GRPCServer and on the
port's, each behind mutual TLS from its own package's TlsCA; the same
requests go to both.  Payloads and status-code names must be equal for
unary, server-stream and bidirectional calls, a raising handler (before
and during a stream), an unknown method, an expired deadline (unary and
stream) and a client's cancel of a stream parked at the server.  The
port's mutual TLS refuses a client without a certificate and one from a
stranger CA, and a server whose certificate does not carry the dialed
name; trace metadata survives a round trip; `track_expiration` gives
the reference's warnings; the RPC metrics count each call.
"""
import datetime
import threading
import time

import grpc
import pytest
from fabric_mod_tpu.comm import grpc_comm as jcomm
from fabric_mod_tpu.comm.tls import TlsCA as JTlsCA
from fabric_mod_tpu.comm.tls import track_expiration as j_track

from fabric_mod_tpu_torch.bccsp import x509
from fabric_mod_tpu_torch.comm import wire
from fabric_mod_tpu_torch.comm.grpc_comm import (GRPCClient, GRPCServer,
                                                 MethodKind, RpcError)
from fabric_mod_tpu_torch.comm.tls import TlsCA, track_expiration
from fabric_mod_tpu_torch.concurrency import live_registered
from fabric_mod_tpu_torch.observability import metrics, tracing

NAME = "srv.example.com"


class Handlers:
    """One set of handlers, registered on both servers."""

    def __init__(self):
        self.parked = threading.Event()
        self.gone = threading.Event()

    def echo(self, request, context):
        return request[::-1]

    def boom(self, request, context):
        raise ValueError("no such thing")

    def slow(self, request, context):
        time.sleep(1.0)
        return request

    def count(self, request, context):
        for i in range(int(request)):
            yield b"n%d" % i

    def bidi(self, request_iter, context):
        md = dict(context.invocation_metadata())
        yield md.get("x-tag", "none").encode()
        for raw in request_iter:
            yield raw.upper()

    def broken(self, request_iter, context):
        for raw in request_iter:
            yield raw
            raise RuntimeError("mid-stream")

    def park(self, request, context):
        context.add_callback(self.gone.set)
        self.parked.set()
        self.gone.wait(20)
        yield b"late"

    def register(self, server, kind_ns):
        for name, kind in (("Echo", "UNARY"), ("Boom", "UNARY"),
                           ("Slow", "UNARY"), ("Count", "SERVER_STREAM"),
                           ("Bidi", "STREAM_STREAM"),
                           ("Broken", "STREAM_STREAM"),
                           ("Park", "SERVER_STREAM")):
            server.register("test.Svc", name, getattr(kind_ns, kind),
                            getattr(self, name.lower()))


def _issue(ca_cls, **kw):
    ca = ca_cls(**kw)
    server = ca.issue(NAME, sans=(NAME, "127.0.0.1"))
    client = ca.issue("client.example.com", server=False)
    return ca, server, client


@pytest.fixture()
def servers():
    """A reference server and a port server over the same handlers, each
    requiring client certificates from its own CA."""
    out = {}
    for side, (ca_cls, srv_cls, cli_cls, kinds) in {
            "ref": (JTlsCA, jcomm.GRPCServer, jcomm.GRPCClient,
                    jcomm.MethodKind),
            "port": (TlsCA, GRPCServer, GRPCClient, MethodKind)}.items():
        ca, (sc, sk), (cc, ck) = _issue(ca_cls)
        handlers = Handlers()
        srv = srv_cls("127.0.0.1:0", sc, sk, ca.cert_pem)
        handlers.register(srv, kinds)
        srv.start()
        cli = cli_cls(f"127.0.0.1:{srv.port}", server_root_pem=ca.cert_pem,
                      client_cert_pem=cc, client_key_pem=ck,
                      override_authority=NAME)
        out[side] = {"srv": srv, "cli": cli, "ca": ca, "h": handlers,
                     "client_pems": (cc, ck)}
    yield out
    for side in out.values():
        side["h"].gone.set()
        side["cli"].close()
        side["srv"].stop(0)


def _outcome(fn):
    """(payloads, status name) of one call, over either package."""
    got = []
    try:
        res = fn()
        if isinstance(res, bytes):
            got.append(res)
        else:
            for item in res:
                got.append(item)
        return got, "OK"
    except (grpc.RpcError, RpcError) as e:
        return got, e.code().name


CASES = {
    "unary": lambda c: c.unary("test.Svc", "Echo", b"abc", timeout=10),
    "unary_raises": lambda c: c.unary("test.Svc", "Boom", b"x", timeout=10),
    "unknown_method": lambda c: c.unary("test.Svc", "Nope", b"x",
                                        timeout=10),
    "unknown_service": lambda c: c.unary("other.Svc", "Echo", b"x",
                                         timeout=10),
    "unary_deadline": lambda c: c.unary("test.Svc", "Slow", b"x",
                                        timeout=0.3),
    "server_stream": lambda c: c.server_stream("test.Svc", "Count", b"5",
                                               timeout=10),
    "server_stream_empty": lambda c: c.server_stream("test.Svc", "Count",
                                                     b"0", timeout=10),
    "bidi": lambda c: c.stream_stream(
        "test.Svc", "Bidi", iter([b"a", b"bc", b""]), timeout=10,
        metadata=[("x-tag", "t1")]),
    "bidi_raises_mid_stream": lambda c: c.stream_stream(
        "test.Svc", "Broken", iter([b"one", b"two"]), timeout=10),
    "stream_deadline": lambda c: c.server_stream("test.Svc", "Park", b"x",
                                                 timeout=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_payloads_and_status_codes_equal_the_references(servers, case):
    ref = _outcome(lambda: CASES[case](servers["ref"]["cli"]))
    got = _outcome(lambda: CASES[case](servers["port"]["cli"]))
    assert got == ref


def test_cancel_of_a_parked_stream_is_cancelled_at_both(servers):
    results = {}
    for side in ("ref", "port"):
        s = servers[side]
        stream = s["cli"].server_stream("test.Svc", "Park", b"x")
        threading.Thread(target=lambda st=stream, h=s["h"]: (
            h.parked.wait(10), st.cancel())).start()
        results[side] = _outcome(lambda st=stream: st)
        # the server saw the client go: the handler's callback ran
        assert s["h"].gone.wait(10), side
    assert results["port"] == results["ref"] == ([], "CANCELLED")


def test_mtls_refuses_a_client_without_a_certificate_or_a_strangers(
        servers):
    port = servers["port"]
    target = f"127.0.0.1:{port['srv'].port}"
    bare = GRPCClient(target, server_root_pem=port["ca"].cert_pem,
                      override_authority=NAME)
    stranger = TlsCA(name="stranger", seed=b"stranger")
    sc, sk = stranger.issue("intruder", server=False)
    foreign = GRPCClient(target, server_root_pem=port["ca"].cert_pem,
                         client_cert_pem=sc, client_key_pem=sk,
                         override_authority=NAME)
    cc, ck = port["client_pems"]
    misnamed = GRPCClient(target, server_root_pem=port["ca"].cert_pem,
                          client_cert_pem=cc, client_key_pem=ck,
                          override_authority="other.example.com")
    for client in (bare, foreign, misnamed):
        with pytest.raises(RpcError) as got:
            client.unary("test.Svc", "Echo", b"x", timeout=5)
        assert got.value.code().name == "UNAVAILABLE"
        client.close()
    # the dialed IP is in the certificate: no override needed
    direct = GRPCClient(target, server_root_pem=port["ca"].cert_pem,
                        client_cert_pem=cc, client_key_pem=ck)
    assert direct.unary("test.Svc", "Echo", b"xy", timeout=5) == b"yx"
    direct.close()


def test_tls_certificates_carry_san_and_eku():
    ca = TlsCA()
    pem, _key = ca.issue("o0.example.com",
                         sans=("o0.example.com", "127.0.0.1"), client=False)
    cert = x509.load_pem_x509_certificate(pem)
    san = cert.extensions.get_extension_for_class(
        x509.SubjectAlternativeName).value
    assert san.get_values_for_type(x509.DNSName) == ["o0.example.com"]
    assert [str(ip) for ip in san.get_values_for_type(x509.IPAddress)] == \
        ["127.0.0.1"]
    eku = cert.extensions.get_extension_for_class(x509.ExtendedKeyUsage)
    assert list(eku.value) == [x509.ExtendedKeyUsageOID.SERVER_AUTH]
    # same seed, same material
    assert TlsCA().issue("o0.example.com", sans=("o0.example.com",
                                                 "127.0.0.1"),
                         client=False) == (pem, _key)


def test_trace_metadata_survives_the_round_trip(servers):
    port = servers["port"]
    seen = []
    srv = GRPCServer("127.0.0.1:0")
    srv.register("trace.Svc", "Get", MethodKind.UNARY,
                 lambda r, ctx: (seen.append(
                     tracing.extract(ctx.invocation_metadata())), b"ok")[1])
    srv.start()
    cli = GRPCClient(f"127.0.0.1:{srv.port}")
    try:
        with tracing.active():
            ctx = tracing.TraceContext(tracing.new_trace_id(), "00ab12cd")
            assert cli.unary("trace.Svc", "Get", b"",
                             metadata=tracing.inject(ctx)) == b"ok"
        assert seen == [ctx]
    finally:
        cli.close()
        srv.stop()
    assert port["srv"].port


def test_track_expiration_gives_the_references_warnings():
    now = datetime.datetime.now(datetime.timezone.utc)
    got, want = [], []
    for ca, sink, track in ((TlsCA(now=now), got, track_expiration),
                            (JTlsCA(), want, j_track)):
        pems = [ca.issue("fresh", valid_days=365)[0],
                ca.issue("soon", valid_days=3)[0],
                ca.issue("gone", valid_days=0)[0]]
        flagged = track(pems, sink.append,
                        now=now + datetime.timedelta(hours=1))
        sink.append(tuple(flagged))
    assert got[-1] == want[-1] == ("CN=soon", "CN=gone")
    assert [w.split(" expires in ")[0] for w in got[:-1]] == \
        [w.split(" expires in ")[0] for w in want[:-1]] == \
        ["certificate CN=soon", "certificate CN=gone has expired"]


def test_rpc_metrics_count_calls_and_stop_joins_every_thread(servers):
    port = servers["port"]
    before = set(live_registered())
    for _ in range(3):
        port["cli"].unary("test.Svc", "Echo", b"m", timeout=5)
    text = metrics.default_provider().render_prometheus()
    assert 'grpc_server_requests_completed{service="test.Svc",' \
           'method="Echo",code="OK"}' in text
    assert "grpc_server_request_duration_seconds_bucket" in text
    port["cli"].close()
    port["srv"].stop(1.0)
    port["srv"].stop(1.0)                  # idempotent
    left = [t.name for t in live_registered()
            if t.structure == "comm.grpc_comm" and t not in before
            and "rpc-send" not in t.name]
    assert left == []
    assert wire.MAX_MESSAGE_BYTES == 100 * 1024 * 1024


def test_calls_are_served_on_descriptors_above_fd_setsize():
    """With over 1,100 descriptors open, the listener, the client's and
    the server's sockets all lie above select()'s 1,024 ceiling; the
    wire still serves a unary call, a server stream and a bidirectional
    one over mutual TLS, as a reference server with the same handlers
    answers them."""
    import os
    import resource
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = 1400
    if soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(want, hard), hard))
    dummies = []
    try:
        while len(dummies) < 1100:
            dummies.append(os.open(os.devnull, os.O_RDONLY))
        ca, (sc, sk), (cc, ck) = _issue(TlsCA)
        handlers = Handlers()
        srv = GRPCServer("127.0.0.1:0", sc, sk, ca.cert_pem)
        handlers.register(srv, MethodKind)
        srv.start()
        cli = GRPCClient(f"127.0.0.1:{srv.port}", server_root_pem=ca.cert_pem,
                         client_cert_pem=cc, client_key_pem=ck,
                         override_authority=NAME)
        try:
            assert srv._server._listener.fileno() > 1024
            got = [_outcome(lambda: CASES[case](cli))
                   for case in ("unary", "server_stream", "bidi")]
        finally:
            handlers.gone.set()
            cli.close()
            srv.stop(0)
    finally:
        for fd in dummies:
            os.close(fd)
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    assert got == [([b"cba"], "OK"),
                   ([b"n0", b"n1", b"n2", b"n3", b"n4"], "OK"),
                   ([b"t1", b"A", b"BC", b""], "OK")]
