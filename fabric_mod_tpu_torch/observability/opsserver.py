"""Operations HTTP server: /metrics /healthz /logspec /version, the debug
routes, the tracer's /trace and /flight, and channel participation.

The port's copy of fabric_mod_tpu/observability/opsserver.py (:101-219;
reference: core/operations/system.go:60-270 — the operations listener
every node runs: the prometheus scrape endpoint, the health checker
registry, dynamic log levels, build info — and the channel
participation API mounted on the orderer's admin listener,
restapi.go).

stdlib http.server on one thread; the handlers read the same
in-process registries the node's components write: the port's
metrics provider, `default_health()`, the logging spec, the tracer's
recorder (observability/tracing.py) and a `ChannelParticipation`
(orderer/participation.py).

Health: long-lived components register a checker in `default_health()`
when they are built and unregister it when they close.  In the port
those are the commit pipes (peer/commitpipe.py: a poisoned pipe flips
/healthz until its owner discards it).  The reference also registers
its device circuit breakers there; the port has none, since no path
falls back from the card to the host, so its default registry carries
commit-pipe checkers only.
"""
from __future__ import annotations

import json
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.observability import diag, tracing
from fabric_mod_tpu_torch.observability import logging as flog
from fabric_mod_tpu_torch.observability.metrics import (MetricsProvider,
                                                        default_provider)

VERSION = "0.3.0"


class HealthRegistry:
    """(reference: the healthz checker registry, system.go:141)"""

    def __init__(self):
        self._checkers: Dict[str, Callable[[], None]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, checker: Callable[[], None]) -> None:
        with self._lock:
            self._checkers[name] = checker

    def unregister(self, name: str) -> None:
        with self._lock:
            self._checkers.pop(name, None)

    def status(self):
        """("OK" | "Service Unavailable", {name: error text}): a checker
        fails by raising."""
        failures = {}
        with self._lock:
            checkers = dict(self._checkers)
        for name, check in checkers.items():
            try:
                check()
            except Exception as e:
                failures[name] = str(e)
        return ("OK" if not failures else "Service Unavailable", failures)


_default_health: Optional[HealthRegistry] = None
_default_health_lock = threading.Lock()


def default_health() -> HealthRegistry:
    """The process-default checker registry, which an OperationsServer
    built without one serves."""
    global _default_health
    with _default_health_lock:
        if _default_health is None:
            _default_health = HealthRegistry()
        return _default_health


class OperationsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 provider: Optional[MetricsProvider] = None,
                 health: Optional[HealthRegistry] = None,
                 participation=None, tls: Optional[dict] = None):
        """`participation`: a ChannelParticipation whose `handle` serves
        /participation/v1/channels[/<id>] (an orderer's; None answers
        404).  `tls`: {"cert": path, "key": path, "client_ca": path?}
        serves HTTPS; with `client_ca`, a client must present a
        certificate that chains to it (the reference's operations TLS
        with clientAuthRequired, system.go:60-120).  The participation
        routes create and delete channel storage: off the loopback,
        serve them only behind client-authenticated TLS."""
        self.provider = provider or default_provider()
        self.health = health or default_health()
        self.participation = participation
        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # quiet
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "text/plain") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode(),
                           "application/json")

            def do_GET(self):
                path = self.path
                if path == "/metrics":
                    self._send(200,
                               ops.provider.render_prometheus().encode())
                elif path == "/healthz":
                    status, failures = ops.health.status()
                    self._json(200 if status == "OK" else 503,
                               {"status": status,
                                "failed_checks": failures})
                elif path == "/logspec":
                    self._json(200, {"spec": flog.current_spec()})
                elif path == "/version":
                    self._json(200, {"Version": VERSION})
                elif path == "/debug/threads":
                    self._send(200, diag.dump_threads().encode())
                elif path.startswith(("/debug/pprof", "/debug/profile")):
                    # the sampling profile, collapsed stacks; ?seconds=N
                    # (at most 30) bounds the run
                    q = parse_qs(urlparse(path).query)
                    try:
                        secs = min(30.0, float(
                            (q.get("seconds") or ["5"])[0]))
                    except ValueError:
                        self._send(400, b"bad seconds parameter")
                        return
                    self._send(200, diag.sample_profile(secs).encode())
                elif path.startswith("/trace"):
                    # recent finished spans, newest last; ?trace_id=
                    # filters one trace, ?limit= bounds the answer
                    q = parse_qs(urlparse(path).query)
                    try:
                        limit = int((q.get("limit") or ["512"])[0])
                    except ValueError:
                        limit = 512
                    tid = (q.get("trace_id") or [None])[0]
                    self._json(200, {
                        "armed": tracing.armed(),
                        "spans": tracing.recorder().recent_spans(
                            trace_id=tid, limit=limit)})
                elif path == "/flight":
                    # block timelines, events, dumps and substage totals
                    self._json(200, tracing.flight_dump())
                elif path.startswith("/participation/"):
                    self._participation("GET")
                else:
                    self._send(404, b"not found")

            def _participation(self, method: str) -> None:
                if ops.participation is None:
                    self._send(404, b"not found")
                    return
                ln = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(ln) if ln else b""
                code, payload = ops.participation.handle(
                    method, self.path, body)
                self._send(code,
                           json.dumps(payload).encode()
                           if payload is not None else b"",
                           "application/json")

            def do_POST(self):
                if self.path.startswith("/participation/"):
                    self._participation("POST")
                else:
                    self._send(404, b"not found")

            def do_DELETE(self):
                if self.path.startswith("/participation/"):
                    self._participation("DELETE")
                else:
                    self._send(404, b"not found")

            def do_PUT(self):
                if self.path == "/logspec":
                    ln = int(self.headers.get("Content-Length", "0"))
                    try:
                        body = json.loads(self.rfile.read(ln) or b"{}")
                        flog.activate_spec(body.get("spec", "info"))
                        self._send(204, b"")
                    except Exception as e:
                        self._send(400, str(e).encode())
                else:
                    self._send(404, b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        if tls:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls["cert"], tls["key"])
            if tls.get("client_ca"):
                ctx.load_verify_locations(tls["client_ca"])
                ctx.verify_mode = ssl.CERT_REQUIRED
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        self.addr = self._httpd.server_address
        self._thread = RegisteredThread(target=self._httpd.serve_forever,
                                        name="opsserver-http",
                                        structure="observability.opsserver")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop serving, close the listener and join the serving thread
        (idempotent)."""
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()
