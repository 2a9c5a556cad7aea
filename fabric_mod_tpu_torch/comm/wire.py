"""The port's RPC wire: gRPC's call model over the standard library.

The reference's services register generic byte handlers over grpcio
(fabric_mod_tpu/comm/grpc_comm.py:7-12): a method path `/service/method`
and opaque payload bytes are the whole contract between a client and a
server.  This module carries that contract over TCP sockets wrapped by
`ssl` (mutual TLS when the server is given a client root), with framing
of its own.  It is not wire-compatible with a real gRPC peer.

Framing.  Every message on a connection is one frame: a type byte, a
4-byte big-endian length and the payload.  The types are HEADERS (a JSON
object: the method path, the call's metadata as [key, value] pairs and
its timeout), MESSAGE (one request or response), HALF_CLOSE (the client
sends no more requests), CANCEL (the client gives the call up) and STATUS
(a JSON object: the status code's number and the details; the server's
last frame of a call).  A connection carries one call at a time: each
streaming call (Broadcast, Deliver, the event Deliver) dials a
connection of its own, and unary calls take a connection from a small
per-client pool of idle ones and give it back after the STATUS.  So one
slow stream never stalls another, and no multiplexing or flow control is
needed beyond TCP's.

Concurrency.  One thread reads a connection; any thread may write it.
Sockets are non-blocking and every call into the SSL object is made
under the connection's lock, so a reader and a writer never use
OpenSSL's connection state at once; a thread waits for the socket in
`poll` (which, unlike `select`, takes descriptors above FD_SETSIZE),
outside the lock.

Status codes carry gRPC's names and numbers (`StatusCode`), and an
`RpcError` has gRPC's `.code()` and `.details()`: a handler's exception
is UNKNOWN, an unregistered method UNIMPLEMENTED, a lost connection
UNAVAILABLE, an expired deadline DEADLINE_EXCEEDED (raised at the
client) and a client's cancel CANCELLED.  Messages are limited to 100
MiB (RESOURCE_EXHAUSTED beyond); TCP keepalive probes an idle connection
after 60 s and gives it up 20 s later (the reference's `_OPTIONS`).
"""
from __future__ import annotations

import enum
import json
import os
import queue
import select
import socket
import ssl
import struct
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from fabric_mod_tpu_torch.concurrency.threads import RegisteredThread
from fabric_mod_tpu_torch.observability.logging import get_logger

log = get_logger("comm.wire")

MAX_MESSAGE_BYTES = 100 * 1024 * 1024
KEEPALIVE_TIME_S = 60
KEEPALIVE_TIMEOUT_S = 20
HANDSHAKE_TIMEOUT_S = 10.0
DIAL_TIMEOUT_S = 20.0
# how long Server.stop waits for its threads once the calls are cancelled
STOP_JOIN_S = 30.0
# idle unary connections a client keeps per target
POOL_IDLE = 4

F_HEADERS, F_MESSAGE, F_HALF_CLOSE, F_CANCEL, F_STATUS = 1, 2, 3, 4, 5
_HDR = struct.Struct(">BI")
_CHUNK = 1 << 16
_POLL_S = 0.5


class MethodKind:
    UNARY = "unary"
    SERVER_STREAM = "server_stream"
    STREAM_STREAM = "stream_stream"


class StatusCode(enum.Enum):
    """gRPC's status codes, by name and number."""
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"<RpcError {code.name}: {details}>")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Oversize(Exception):
    pass


# -- TLS contexts ------------------------------------------------------------

_ctx_cache: Dict[tuple, ssl.SSLContext] = {}
_ctx_lock = threading.Lock()


def _load_chain(ctx: ssl.SSLContext, cert_pem: bytes, key_pem: bytes) -> None:
    """`load_cert_chain` reads files only: write the PEMs to a private
    temporary directory, load them, and remove it."""
    with tempfile.TemporaryDirectory() as d:
        cert_path = os.path.join(d, "cert.pem")
        key_path = os.path.join(d, "key.pem")
        for path, data in ((cert_path, cert_pem), (key_path, key_pem)):
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(data)
        ctx.load_cert_chain(cert_path, key_path)


def _cached(key: tuple, make: Callable[[], ssl.SSLContext]) -> ssl.SSLContext:
    with _ctx_lock:
        ctx = _ctx_cache.get(key)
    if ctx is None:
        ctx = make()
        with _ctx_lock:
            if len(_ctx_cache) >= 64:
                _ctx_cache.clear()
            _ctx_cache[key] = ctx
    return ctx


def server_context(cert_pem: bytes, key_pem: bytes,
                   client_root_pem: Optional[bytes] = None) -> ssl.SSLContext:
    """A server context; with `client_root_pem` every client must present
    a certificate that chains to it (CERT_REQUIRED)."""
    def make():
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        _load_chain(ctx, cert_pem, key_pem)
        if client_root_pem is not None:
            ctx.load_verify_locations(cadata=client_root_pem.decode())
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx
    return _cached(("server", cert_pem, key_pem, client_root_pem), make)


def client_context(server_root_pem: bytes,
                   client_cert_pem: Optional[bytes] = None,
                   client_key_pem: Optional[bytes] = None) -> ssl.SSLContext:
    """A client context that checks the server's chain against
    `server_root_pem` and its host name, and presents the client
    certificate when one is given."""
    def make():
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.check_hostname = True
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(cadata=server_root_pem.decode())
        if client_cert_pem is not None:
            _load_chain(ctx, client_cert_pem, client_key_pem)
        return ctx
    return _cached(("client", server_root_pem, client_cert_pem,
                    client_key_pem), make)


def split_address(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host or "127.0.0.1", int(port)


def _tune(sock: socket.socket) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", KEEPALIVE_TIME_S),
                     ("TCP_KEEPINTVL", KEEPALIVE_TIMEOUT_S),
                     ("TCP_KEEPCNT", 1)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)


def _ready(fd: int, write: bool, timeout_s: float) -> bool:
    """Whether `fd` turns writable (or readable) within `timeout_s`; an
    error or hang-up counts as ready.  `poll` has no FD_SETSIZE ceiling,
    so a process with many descriptors open still waits here.  Raises
    ValueError or OSError for a closed descriptor."""
    p = select.poll()
    p.register(fd, select.POLLOUT if write else select.POLLIN)
    return bool(p.poll(timeout_s * 1000.0))


# -- one connection ----------------------------------------------------------

class FramedSocket:
    """A connected (TLS or plain) socket read and written in frames.
    `recv_frame` is called by one thread at a time; `send_frames` by any
    thread.  Deadlines are `time.monotonic()` values; past one a call
    raises socket.timeout.  A closed or broken connection raises
    ConnectionError."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._fd = sock.fileno()
        sock.setblocking(False)
        self._io = threading.Lock()        # every call into the socket
        self._wlock = threading.Lock()     # one writer's frames at a time
        self._rbuf = bytearray()
        self.closed = False

    def peer_der(self) -> Optional[bytes]:
        if isinstance(self._sock, ssl.SSLSocket):
            return self._sock.getpeercert(binary_form=True)
        return None

    def _wait(self, write: bool, deadline: Optional[float]) -> None:
        if self.closed:
            raise ConnectionError("connection closed")
        slice_s = _POLL_S
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise socket.timeout("deadline exceeded")
            slice_s = min(slice_s, left)
        try:
            _ready(self._fd, write, slice_s)
        except (OSError, ValueError):
            raise ConnectionError("connection closed") from None

    def send_frames(self, frames, deadline: Optional[float] = None,
                    lock_timeout: Optional[float] = None) -> None:
        """Write [(type, payload), ...] as one burst."""
        data = b"".join(_HDR.pack(t, len(p)) + p for t, p in frames)
        got = (self._wlock.acquire() if lock_timeout is None
               else self._wlock.acquire(timeout=lock_timeout))
        if not got:
            raise ConnectionError("connection busy")
        try:
            view = memoryview(data)
            off = 0
            while off < len(data):
                chunk = view[off:off + _CHUNK]
                n = None
                with self._io:
                    if self.closed:
                        raise ConnectionError("connection closed")
                    try:
                        n = self._sock.send(chunk)
                    except (ssl.SSLWantWriteError, ssl.SSLWantReadError,
                            BlockingIOError, InterruptedError):
                        n = None
                    except (OSError, ssl.SSLError) as e:
                        raise ConnectionError(str(e)) from None
                if n is None:
                    self._wait(True, deadline)
                    continue
                off += n
        finally:
            self._wlock.release()

    def send_frame(self, ftype: int, payload: bytes = b"",
                   deadline: Optional[float] = None) -> None:
        self.send_frames([(ftype, payload)], deadline)

    def recv_frame(self, deadline: Optional[float] = None
                   ) -> Tuple[int, bytes]:
        buf = self._rbuf
        while True:
            if len(buf) >= _HDR.size:
                ftype, n = _HDR.unpack_from(buf)
                if n > MAX_MESSAGE_BYTES:
                    raise _Oversize(f"received message larger than max "
                                    f"({n} vs. {MAX_MESSAGE_BYTES})")
                if len(buf) >= _HDR.size + n:
                    payload = bytes(buf[_HDR.size:_HDR.size + n])
                    del buf[:_HDR.size + n]
                    return ftype, payload
            data = None
            with self._io:
                if self.closed:
                    raise ConnectionError("connection closed")
                try:
                    data = self._sock.recv(_CHUNK)
                except (ssl.SSLWantReadError, ssl.SSLWantWriteError,
                        BlockingIOError, InterruptedError):
                    data = None
                except (OSError, ssl.SSLError) as e:
                    raise ConnectionError(str(e)) from None
            if data is None:
                self._wait(False, deadline)
                continue
            if not data:
                raise ConnectionError("connection closed by the peer")
            buf += data

    def idle_and_open(self) -> bool:
        """True when nothing arrived on an idle pooled connection: a
        readable idle connection was closed (or broken) by the server."""
        if self.closed or self._rbuf:
            return False
        try:
            return not _ready(self._fd, False, 0)
        except (OSError, ValueError):
            return False

    def close(self) -> None:
        with self._io:
            if self.closed:
                return
            self.closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()


# -- server ------------------------------------------------------------------

class ServerContext:
    """What a handler sees of its call (the gRPC ServicerContext subset
    the port's services use)."""

    def __init__(self, call: "_ServerCall"):
        self._call = call

    def invocation_metadata(self) -> Tuple[Tuple[str, str], ...]:
        return self._call.metadata

    def add_callback(self, fn: Callable[[], None]) -> bool:
        """Run `fn` when the call ends: the client cancels or goes away,
        the server stops, or the call completes.  A call that has already
        ended runs `fn` now and answers False."""
        return self._call.add_callback(fn)

    def auth_context(self) -> Dict[str, List[bytes]]:
        """The client's TLS certificate, in DER and PEM; {} without
        mutual TLS."""
        der = self._call.peer_der
        if not der:
            return {}
        pem = ssl.DER_cert_to_PEM_cert(der).encode()
        return {"x509_der_cert": [der], "x509_pem_cert": [pem],
                "transport_security_type": [b"ssl"]}


_END = object()


class _ServerCall:
    """One call on a server connection: its request queue, its end and
    its callbacks."""

    def __init__(self, conn: FramedSocket, header: dict,
                 peer_der: Optional[bytes]):
        self.conn = conn
        self.path = header.get("path", "")
        self.metadata = tuple((str(k), str(v))
                              for k, v in header.get("metadata") or ())
        timeout = header.get("timeout")
        self.deadline = (time.monotonic() + float(timeout)
                         if timeout is not None else None)
        self.peer_der = peer_der
        self.requests: "queue.Queue" = queue.Queue()
        self.unary_request: Optional[bytes] = None
        self.half_closed = False
        self.cancelled = threading.Event()
        self.terminated = threading.Event()
        self.finished = False              # STATUS sent
        self._cb_lock = threading.Lock()
        self._callbacks: List[Callable[[], None]] = []

    def add_callback(self, fn) -> bool:
        with self._cb_lock:
            if not self.terminated.is_set():
                self._callbacks.append(fn)
                return True
        fn()
        return False

    def terminate(self) -> None:
        with self._cb_lock:
            if self.terminated.is_set():
                return
            self.terminated.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn()
            except Exception as e:
                log.debug("call callback raised: %r", e)

    def cancel(self) -> None:
        self.cancelled.set()
        self.requests.put(_END)
        self.terminate()

    def request_iter(self) -> Iterator[bytes]:
        while True:
            item = self.requests.get()
            if item is _END:
                return
            yield item

    def first_request(self) -> Optional[bytes]:
        item = self.requests.get()
        return None if item is _END else item

    def send_status(self, code: StatusCode, details: str = "") -> None:
        if self.finished:
            return
        self.finished = True
        body = json.dumps({"code": code.value, "details": details}).encode()
        try:
            self.conn.send_frame(F_STATUS, body, deadline=(
                time.monotonic() + HANDSHAKE_TIMEOUT_S))
        except (ConnectionError, socket.timeout):
            pass


class Server:
    """Listens on `address`, serves each connection on a thread of its own
    and each streaming call on another.  `lookup(path)` gives a method's
    (kind, handler) or None.  `max_workers` bounds the handlers running at
    once, as the reference's thread pool does: a call past it waits."""

    def __init__(self, address: str, lookup: Callable[[str], Optional[tuple]],
                 ssl_context: Optional[ssl.SSLContext] = None,
                 max_workers: int = 16):
        self._lookup = lookup
        self._ctx = ssl_context
        self._slots = threading.BoundedSemaphore(max(1, max_workers))
        host, port = split_address(address)
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind((host, port))
        except OSError as e:
            self._listener.close()
            raise RuntimeError(f"could not bind {address}: {e}") from None
        self.port = self._listener.getsockname()[1]
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._calls: set = set()
        self._stopping = threading.Event()
        self._stopped = False
        self._accept_thread: Optional[RegisteredThread] = None

    def start(self) -> None:
        """Listen (a dial before start() is refused) and serve."""
        self._listener.listen(128)
        self._accept_thread = RegisteredThread(
            target=self._accept_loop, name=f"rpc-accept[{self.port}]",
            structure="comm.grpc_comm")
        self._accept_thread.start()

    def _spawn(self, target, name: str, *args) -> None:
        t = RegisteredThread(target=target, args=args, name=name,
                             structure="comm.grpc_comm")
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                if not _ready(self._listener.fileno(), False, _POLL_S):
                    continue
            except (OSError, ValueError):
                return
            try:
                raw, _addr = self._listener.accept()
            except OSError:
                continue
            if self._stopping.is_set():
                raw.close()
                return
            self._spawn(self._serve_conn, f"rpc-conn[{self.port}]", raw)

    def _serve_conn(self, raw: socket.socket) -> None:
        try:
            _tune(raw)
            if self._ctx is not None:
                raw.settimeout(HANDSHAKE_TIMEOUT_S)
                sock = self._ctx.wrap_socket(raw, server_side=True)
            else:
                sock = raw
        except (OSError, ssl.SSLError) as e:
            log.debug("TLS handshake refused: %r", e)
            raw.close()
            return
        conn = FramedSocket(sock)
        with self._lock:
            if self._stopping.is_set():
                conn.close()
                return
            self._conns.add(conn)
        call: Optional[_ServerCall] = None
        entry = None
        try:
            while True:
                try:
                    ftype, payload = conn.recv_frame()
                except _Oversize as e:
                    if call is not None and not call.finished:
                        call.send_status(StatusCode.RESOURCE_EXHAUSTED,
                                         str(e))
                    return
                except (ConnectionError, socket.timeout):
                    return
                if ftype == F_HEADERS:
                    if call is not None and not call.terminated.is_set():
                        return                 # one call at a time
                    call = _ServerCall(conn, json.loads(payload),
                                       conn.peer_der())
                    entry = self._lookup(call.path)
                    if entry is None:
                        call.send_status(StatusCode.UNIMPLEMENTED,
                                         "Method not found!")
                        call.terminate()
                        continue
                    with self._lock:
                        self._calls.add(call)
                    if entry[0] != MethodKind.UNARY:
                        self._spawn(self._run_stream,
                                    f"rpc-call[{call.path}]", call, entry)
                elif call is None or call.terminated.is_set():
                    continue                   # after a refused call
                elif ftype == F_MESSAGE:
                    if entry[0] == MethodKind.UNARY:
                        call.unary_request = payload
                    else:
                        call.requests.put(payload)
                elif ftype == F_HALF_CLOSE:
                    call.half_closed = True
                    if entry[0] == MethodKind.UNARY:
                        self._run_unary(call, entry[1])
                    else:
                        call.requests.put(_END)
                elif ftype == F_CANCEL:
                    call.cancel()
                else:
                    return
        finally:
            if call is not None:
                call.cancel()
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    def _run_unary(self, call: _ServerCall, fn) -> None:
        ctx = ServerContext(call)
        self._slots.acquire()
        try:
            if call.unary_request is None:
                call.send_status(StatusCode.INTERNAL,
                                 "unary call without a request")
                return
            try:
                resp = fn(call.unary_request, ctx)
            except Exception as e:
                call.send_status(StatusCode.UNKNOWN,
                                 f"Exception calling application: {e}")
                return
            if len(resp) > MAX_MESSAGE_BYTES:
                call.send_status(StatusCode.RESOURCE_EXHAUSTED,
                                 "Sent message larger than max")
                return
            try:
                call.conn.send_frame(F_MESSAGE, bytes(resp))
            except (ConnectionError, socket.timeout):
                return
            call.send_status(StatusCode.OK)
        finally:
            self._slots.release()
            call.terminate()
            with self._lock:
                self._calls.discard(call)

    def _run_stream(self, call: _ServerCall, entry) -> None:
        kind, fn = entry
        ctx = ServerContext(call)
        result = None
        self._slots.acquire()
        try:
            try:
                if kind == MethodKind.SERVER_STREAM:
                    request = call.first_request()
                    if request is None:
                        return
                    result = fn(request, ctx)
                else:
                    result = fn(call.request_iter(), ctx)
            except Exception as e:
                call.send_status(StatusCode.UNKNOWN,
                                 f"Exception calling application: {e}")
                return
            try:
                for item in result:
                    if call.cancelled.is_set():
                        return
                    if len(item) > MAX_MESSAGE_BYTES:
                        call.send_status(StatusCode.RESOURCE_EXHAUSTED,
                                         "Sent message larger than max")
                        return
                    call.conn.send_frame(F_MESSAGE, bytes(item))
            except (ConnectionError, socket.timeout):
                return
            except Exception as e:
                call.send_status(StatusCode.UNKNOWN,
                                 f"Exception iterating responses: {e}")
                return
            if not call.cancelled.is_set():
                call.send_status(StatusCode.OK)
        finally:
            self._slots.release()
            close = getattr(result, "close", None)
            if close is not None:
                try:
                    close()
                except Exception as e:
                    log.debug("closing a handler's stream raised: %r", e)
            call.terminate()
            with self._lock:
                self._calls.discard(call)

    def stop(self, grace: Optional[float] = 1.0) -> None:
        """Refuse new calls, let calls in flight run for up to `grace`
        seconds, then cancel them, close every connection and join every
        serving thread (a thread still serving STOP_JOIN_S later is
        logged, not waited on).  Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._stopping.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join()
        deadline = time.monotonic() + (grace or 0.0)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._calls:
                    break
            time.sleep(0.01)
        with self._lock:
            calls, conns = list(self._calls), list(self._conns)
        for call in calls:
            call.cancel()
        for conn in conns:
            conn.close()
        # a handler that ignores its call's end is named, not waited on
        # for ever
        deadline = time.monotonic() + STOP_JOIN_S
        while True:
            with self._lock:
                threads = [t for t in self._threads if t.is_alive()]
            if not threads:
                break
            if time.monotonic() >= deadline:
                log.warning("server on port %d: threads still serving "
                            "after stop: %s", self.port,
                            [t.name for t in threads])
                break
            threads[0].join(max(0.01, deadline - time.monotonic()))


# -- client ------------------------------------------------------------------

def _status_of(payload: bytes) -> Tuple[StatusCode, str]:
    d = json.loads(payload)
    try:
        code = StatusCode(int(d.get("code", 2)))
    except ValueError:
        code = StatusCode.UNKNOWN
    return code, str(d.get("details", ""))


def _header(path: str, metadata, timeout: Optional[float]) -> bytes:
    return json.dumps({"path": path,
                       "metadata": [list(kv) for kv in (metadata or ())],
                       "timeout": timeout}).encode()


def _check_size(payload: bytes) -> None:
    if len(payload) > MAX_MESSAGE_BYTES:
        raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                       f"Sent message larger than max ({len(payload)} vs. "
                       f"{MAX_MESSAGE_BYTES})")


class Channel:
    """The client side for one target: dials TLS connections (the
    server's chain and host name checked against `ssl_context`'s roots
    and `server_hostname`), pools idle unary connections, and gives
    each streaming call its own."""

    def __init__(self, target: str, ssl_context: Optional[ssl.SSLContext],
                 server_hostname: Optional[str] = None):
        self.target = target
        self._addr = split_address(target)
        self._ctx = ssl_context
        self._hostname = server_hostname or self._addr[0]
        self._lock = threading.Lock()
        self._idle: List[FramedSocket] = []
        self._streams: set = set()
        self._closed = False

    def dial(self, deadline: Optional[float]) -> FramedSocket:
        if self._closed:
            raise RpcError(StatusCode.CANCELLED, "Channel closed!")
        timeout = DIAL_TIMEOUT_S
        if deadline is not None:
            timeout = max(0.001, min(timeout, deadline - time.monotonic()))
        try:
            raw = socket.create_connection(self._addr, timeout=timeout)
        except socket.timeout:
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except OSError as e:
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"failed to connect to {self.target}: {e}"
                           ) from None
        try:
            _tune(raw)
            if self._ctx is not None:
                raw.settimeout(min(timeout, HANDSHAKE_TIMEOUT_S))
                sock = self._ctx.wrap_socket(
                    raw, server_hostname=self._hostname)
            else:
                sock = raw
        except socket.timeout:
            raw.close()
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except (OSError, ssl.SSLError) as e:
            raw.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"TLS handshake with {self.target} failed: {e}"
                           ) from None
        return FramedSocket(sock)

    def _take(self, deadline: Optional[float]) -> FramedSocket:
        while True:
            with self._lock:
                conn = self._idle.pop() if self._idle else None
            if conn is None:
                return self.dial(deadline)
            if conn.idle_and_open():
                return conn
            conn.close()

    def _give(self, conn: FramedSocket) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < POOL_IDLE:
                self._idle.append(conn)
                return
        conn.close()

    def unary(self, path: str, request: bytes,
              timeout: Optional[float] = None, metadata=None) -> bytes:
        _check_size(request)
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        conn = self._take(deadline)
        try:
            conn.send_frames([(F_HEADERS, _header(path, metadata, timeout)),
                              (F_MESSAGE, bytes(request)),
                              (F_HALF_CLOSE, b"")], deadline)
            response = None
            while True:
                ftype, payload = conn.recv_frame(deadline)
                if ftype == F_MESSAGE:
                    response = payload
                elif ftype == F_STATUS:
                    code, details = _status_of(payload)
                    break
        except socket.timeout:
            conn.close()
            raise RpcError(StatusCode.DEADLINE_EXCEEDED,
                           "Deadline Exceeded") from None
        except _Oversize as e:
            conn.close()
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED, str(e)) from None
        except ConnectionError as e:
            conn.close()
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from None
        self._give(conn)
        if code != StatusCode.OK:
            raise RpcError(code, details)
        if response is None:
            raise RpcError(StatusCode.INTERNAL, "no response message")
        return response

    def stream(self, path: str, requests, timeout: Optional[float] = None,
               metadata=None) -> "ClientStream":
        call = ClientStream(self, path, requests, timeout, metadata)
        with self._lock:
            self._streams = {s for s in self._streams if s.is_active()}
            self._streams.add(call)
        return call

    def close(self) -> None:
        """Close idle connections and cancel every active stream."""
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
            streams, self._streams = list(self._streams), set()
        for conn in idle:
            conn.close()
        for s in streams:
            s.cancel()


class ClientStream:
    """A streaming call: iterate it for the responses.  Its requests are
    written by a thread of its own as `requests` yields them, then a
    HALF_CLOSE.  `cancel()` ends it from any thread; iteration then
    raises CANCELLED."""

    def __init__(self, channel: Channel, path: str, requests,
                 timeout: Optional[float], metadata):
        self._deadline = (time.monotonic() + timeout
                          if timeout is not None else None)
        self._lock = threading.Lock()
        self._code: Optional[StatusCode] = None
        self._error: Optional[RpcError] = None
        self._conn: Optional[FramedSocket] = None
        try:
            self._conn = channel.dial(self._deadline)
            self._conn.send_frame(F_HEADERS, _header(path, metadata, timeout),
                                  self._deadline)
        except RpcError as e:
            self._fail(e)
        except (ConnectionError, socket.timeout) as e:
            self._fail(RpcError(StatusCode.UNAVAILABLE, str(e)))
        if self._conn is not None and self._error is None:
            self._writer = RegisteredThread(
                target=self._write, args=(requests,),
                name=f"rpc-send[{path}]", structure="comm.grpc_comm")
            self._writer.start()

    def _fail(self, err: RpcError) -> None:
        with self._lock:
            if self._code is None:
                self._code, self._error = err.code(), err
        if self._conn is not None:
            self._conn.close()

    def _write(self, requests) -> None:
        conn = self._conn
        try:
            for req in requests:
                if self._code is not None:
                    return
                _check_size(req)
                conn.send_frame(F_MESSAGE, bytes(req))
            if self._code is None:
                conn.send_frame(F_HALF_CLOSE)
        except RpcError as e:
            self._fail(e)
        except (ConnectionError, socket.timeout):
            pass                           # the reader sees the loss
        except Exception as e:
            self._fail(RpcError(StatusCode.CANCELLED,
                                f"Exception iterating requests: {e}"))

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._error is not None:
            raise self._error
        if self._code is not None:
            raise StopIteration
        try:
            ftype, payload = self._conn.recv_frame(self._deadline)
        except socket.timeout:
            self.cancel(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
            raise self._error from None
        except _Oversize as e:
            self._fail(RpcError(StatusCode.RESOURCE_EXHAUSTED, str(e)))
            raise self._error from None
        except ConnectionError as e:
            self._fail(RpcError(StatusCode.UNAVAILABLE, str(e)))
            raise self._error from None
        if ftype == F_MESSAGE:
            return payload
        if ftype == F_STATUS:
            code, details = _status_of(payload)
            if code == StatusCode.OK:
                with self._lock:
                    if self._code is None:
                        self._code = code
                self._conn.close()
                raise StopIteration
            self._fail(RpcError(code, details))
            raise self._error
        self._fail(RpcError(StatusCode.INTERNAL,
                            f"unexpected frame type {ftype}"))
        raise self._error

    def cancel(self, code: StatusCode = StatusCode.CANCELLED,
               details: str = "Locally cancelled by application!") -> bool:
        with self._lock:
            if self._code is not None:
                return False
        conn = self._conn
        if conn is not None:
            try:
                conn.send_frames([(F_CANCEL, b"")],
                                 deadline=time.monotonic() + 0.2,
                                 lock_timeout=0.2)
            except (ConnectionError, socket.timeout):
                pass
        self._fail(RpcError(code, details))
        return True

    def is_active(self) -> bool:
        return self._code is None
