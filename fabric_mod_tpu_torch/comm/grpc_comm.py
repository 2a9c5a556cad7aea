"""RPC server and client wrappers over mutual TLS.

The port's copy of fabric_mod_tpu/comm/grpc_comm.py (reference:
internal/pkg/comm — GRPCServer at server.go:268 with client-certificate
verification, GRPCClient at client.go:211, keepalive and message-size
options in config.go).

The framework's wire messages are the deterministic hand-rolled codec
(protos/wire.py), so services register generic byte handlers: the
method path carries the service contract, the payload is our encoding.
The reference carries them over grpcio; the port carries the same paths
and payload bytes over its own framing on `ssl` sockets (comm/wire.py),
with gRPC's three call kinds, status codes, deadlines, cancels and
metadata.  This is the control plane; device batches never cross these
sockets.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from fabric_mod_tpu_torch.comm import wire
from fabric_mod_tpu_torch.comm.wire import (MethodKind, RpcError,  # noqa: F401
                                            StatusCode)
from fabric_mod_tpu_torch.concurrency.locks import RegisteredLock


# -- RPC observability (reference: common/grpcmetrics/interceptor.go +
# -- common/grpclogging/server.go — every server handler is wrapped
# -- with request counters, a duration histogram, and debug logs) -----------

_rpc_metrics_lock = RegisteredLock("comm.grpc_comm._rpc_metrics_lock")
_rpc_metrics = None


def _get_rpc_metrics():
    global _rpc_metrics
    if _rpc_metrics is not None:           # hot path: no lock
        return _rpc_metrics
    with _rpc_metrics_lock:
        if _rpc_metrics is None:
            from fabric_mod_tpu_torch.observability.metrics import (
                MetricOpts, default_provider)
            prov = default_provider()
            _rpc_metrics = (
                prov.new_counter(MetricOpts(
                    "grpc", "server", "requests_completed",
                    "RPCs completed", ("service", "method", "code"))),
                prov.new_histogram(MetricOpts(
                    "grpc", "server", "request_duration_seconds",
                    "RPC handling time", ("service", "method"))),
            )
        return _rpc_metrics


def _observe(service: str, method: str, kind: str, fn):
    """Wrap a handler with counters + duration (streams time the full
    stream life, like the reference's stream interceptor)."""
    from fabric_mod_tpu_torch.observability.logging import get_logger
    log = get_logger("comm.grpc")

    def wrapped(request, context):
        counter, hist = _get_rpc_metrics()
        t0 = time.perf_counter()
        code = "OK"
        try:
            result = fn(request, context)
            if kind != MethodKind.UNARY:
                # drain-through generator so the duration covers the
                # whole stream, not just handler setup; a mid-stream
                # raise must count as ERROR, not OK
                def stream():
                    scode = "OK"
                    try:
                        yield from result
                    except BaseException:
                        scode = "ERROR"
                        raise
                    finally:
                        hist.with_labels(service, method).observe(
                            time.perf_counter() - t0)
                        counter.with_labels(service, method,
                                            scode).add(1)
                return stream()
            return result
        except Exception:
            code = "ERROR"
            raise
        finally:
            if kind == MethodKind.UNARY:
                hist.with_labels(service, method).observe(
                    time.perf_counter() - t0)
                counter.with_labels(service, method, code).add(1)
                log.debug("%s/%s -> %s", service, method, code)
            elif code == "ERROR":
                counter.with_labels(service, method, "ERROR").add(1)
    return wrapped


class GRPCServer:
    """An mTLS server with generic byte-level method registration.
    `client_root_pem` makes client certificates required."""

    def __init__(self, address: str = "127.0.0.1:0",
                 server_cert_pem: Optional[bytes] = None,
                 server_key_pem: Optional[bytes] = None,
                 client_root_pem: Optional[bytes] = None,
                 max_workers: int = 16):
        self._services: Dict[str, Dict[str, Tuple[str, Callable]]] = {}
        self._methods: Dict[str, Tuple[str, Callable]] = {}
        ctx = None
        if server_cert_pem is not None:
            ctx = wire.server_context(server_cert_pem, server_key_pem,
                                      client_root_pem)
        self._server = wire.Server(address, self._methods.get, ctx,
                                   max_workers=max_workers)
        self.port = self._server.port

    def register(self, service: str, method: str, kind: str,
                 handler: Callable) -> None:
        self._services.setdefault(service, {})[method] = (kind, handler)

    def start(self) -> None:
        for service, methods in self._services.items():
            for name, (kind, fn) in methods.items():
                self._methods[f"/{service}/{name}"] = (
                    kind, _observe(service, name, kind, fn))
        self._server.start()

    def stop(self, grace: Optional[float] = 1.0) -> None:
        """End calls in flight after `grace` seconds (0 aborts them at
        once) and join every serving thread; idempotent."""
        self._server.stop(grace)


class GRPCClient:
    """An mTLS channel + method helpers.  `override_authority` is the
    host name the server's certificate must carry (the TLS server name);
    by default the target's host."""

    def __init__(self, target: str,
                 server_root_pem: Optional[bytes] = None,
                 client_cert_pem: Optional[bytes] = None,
                 client_key_pem: Optional[bytes] = None,
                 override_authority: Optional[str] = None):
        ctx = None
        if server_root_pem is not None:
            ctx = wire.client_context(server_root_pem, client_cert_pem,
                                      client_key_pem)
        self._channel = wire.Channel(target, ctx,
                                     server_hostname=override_authority)

    # `metadata` on each helper: optional [(key, value)] pairs (the
    # trace-context carrier observability/tracing.inject builds)

    def unary(self, service: str, method: str, request: bytes,
              timeout: Optional[float] = 30.0, metadata=None) -> bytes:
        return self._channel.unary(f"/{service}/{method}", request,
                                   timeout=timeout, metadata=metadata)

    def server_stream(self, service: str, method: str, request: bytes,
                      timeout: Optional[float] = None, metadata=None):
        return self._channel.stream(f"/{service}/{method}", iter([request]),
                                    timeout=timeout, metadata=metadata)

    def stream_stream(self, service: str, method: str, requests,
                      timeout: Optional[float] = None, metadata=None):
        return self._channel.stream(f"/{service}/{method}", requests,
                                    timeout=timeout, metadata=metadata)

    def close(self) -> None:
        self._channel.close()
