"""Gossip transport: authenticated peer-to-peer message passing.

The port's copy of fabric_mod_tpu/gossip/comm.py (reference:
gossip/comm/comm_impl.go — every delivered message is attributed to the
sender that the authenticated handshake of :411 established; here
attribution is by sender PKI-ID).  Two networks share one
register/send surface: `InProcNetwork` (:70) delivers between
in-process nodes, and `GRPCGossipNetwork` (:108) over the wire
(comm/grpc_comm.py), each node's endpoint its host:port, with
`GossipAuth` (:32) binding each connection to an MSP identity by a
signed handshake over the TLS client certificate.  `sign_once` and
`send_signed` (reference :526, :534) are the dissemination relay's
pre-signed sends: one signature per frame, the same envelope bytes to
every tree child.

`InProcNetwork.send` runs the receiver's handler on the sender's thread.
The reference answers any exception of the handler with "not delivered";
here a handler answers the protocol's own rejections itself (a message
that does not decode or verify is dropped inside `GossipNode`), and
anything else it raises — a device error of the verifier among them —
propagates to the sender.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.bccsp import x509
from fabric_mod_tpu_torch.comm.grpc_comm import (GRPCClient, GRPCServer,
                                                 MethodKind)
from fabric_mod_tpu_torch.concurrency import (GuardedQueue, RegisteredLock,
                                              RegisteredThread, assert_joined)
from fabric_mod_tpu_torch.gossip.protoext import sign_message
from fabric_mod_tpu_torch.observability.logging import get_logger
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils.retry import Retrier

log = get_logger("gossip.comm")

Handler = Callable[[bytes, bytes], None]     # (src_pki_id, envelope bytes)

# the reference's FABRIC_MOD_TPU_GOSSIP_SEND_RETRIES default
SEND_RETRIES = 2


class GossipAuth:
    """Connection-authentication hooks for the wire gossip transport
    (reference: comm_impl.go:411 authenticateRemotePeer — the signed
    TLS-binding handshake that ties a connection to an MSP identity).

    `identity`: this node's serialized MSP identity; `sign(data)`: a
    signature by that identity's key; `validate(identity_bytes) ->
    pki_id`: MSP-validate a remote identity (raise when invalid) — wire
    it to IdentityMapper.put; `verify(pki_id, data, sig) -> bool` — wire
    it to IdentityMapper.verify.
    """

    def __init__(self, identity: bytes, sign, validate, verify):
        self.identity = identity
        self.sign = sign
        self.validate = validate
        self.verify = verify


_HSK_CTX = b"gossip-handshake-v1\x00"


def _der_hash(der: bytes) -> bytes:
    return hashlib.sha256(der).digest()


def _pem_cert_der_hash(pem: bytes) -> bytes:
    """Stable digest of a TLS certificate: the hash of its DER, not of
    the PEM (PEM wrapping differs between a client's file and the
    server's view of the connection)."""
    return _der_hash(x509.load_pem_x509_certificate(pem).der())


class InProcNetwork:
    """Endpoint registry + direct delivery (the wire stand-in)."""

    def __init__(self):
        self._lock = RegisteredLock("gossip.comm._lock")
        self._handlers: Dict[str, Handler] = {}
        self.partitioned: set = set()        # endpoints cut off (tests)

    def register(self, endpoint: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[endpoint] = handler

    def unregister(self, endpoint: str) -> None:
        with self._lock:
            self._handlers.pop(endpoint, None)

    def send(self, src_endpoint: str, src_pki_id: bytes,
             dst_endpoint: str, env_bytes: bytes) -> bool:
        """Deliver one envelope; False when the destination is unknown
        or either end is partitioned, or an armed drop-mode rule loses
        it on the wire (redelivery and anti-entropy must repair it)."""
        if faults.point("gossip.comm.drop"):
            return False
        with self._lock:
            if (src_endpoint in self.partitioned or
                    dst_endpoint in self.partitioned):
                return False
            handler = self._handlers.get(dst_endpoint)
        if handler is None:
            return False
        handler(src_pki_id, env_bytes)
        return True


class GRPCGossipNetwork:
    """The same register/send surface over the wire — one node's gossip
    endpoint is its host:port (reference: gossip/comm's GossipStream
    service, collapsed to a `Gossip/Message` unary call; with mTLS,
    transport-level peer auth complements the per-envelope MSP signature
    every message already carries).

    Remote sends are asynchronous: per-destination bounded queues
    (`GuardedQueue`, consumer pinned to the sender thread) drained by one
    sender thread each — a dead peer drops its own traffic, never
    blocking the caller (which may be an inbound RPC worker); gossip
    tolerates the loss.  A send is retried `send_retries` times (the
    reference's default, 2) on the Retrier's jittered backoff; the fault
    point ``gossip.comm.send`` sits on every attempt."""

    SERVICE = ("Gossip", "Message")
    QUEUE_CAP = 256

    SERVICE_CONNECT = ("Gossip", "Connect")
    NONCE_TTL_S = 30.0
    SESSION_TTL_S = 3600.0
    SESSION_CAP = 4096

    def __init__(self, listen_address: str = "127.0.0.1:0",
                 server_cert: Optional[bytes] = None,
                 server_key: Optional[bytes] = None,
                 client_ca: Optional[bytes] = None,
                 client_cert: Optional[bytes] = None,
                 client_key: Optional[bytes] = None,
                 send_timeout_s: float = 1.5,
                 auth: Optional[GossipAuth] = None,
                 send_retries: int = SEND_RETRIES,
                 retrier: Optional[Retrier] = None):
        """With `auth`, every connection must complete the signed
        handshake before Message calls are accepted: the remote signs
        (context ‖ server nonce ‖ its TLS client-certificate digest),
        the server checks the digest against the certificate actually
        presented on this connection and MSP-validates the identity.
        Messages are then attributed to the handshake identity — a
        claimed sender that differs from it is dropped."""
        self._client_tls = (client_ca, client_cert, client_key)
        self._timeout = send_timeout_s
        self._auth = auth
        self._send_retries = max(0, send_retries)
        self._retrier = retrier if retrier is not None else Retrier(
            base_s=0.05, max_s=min(1.0, send_timeout_s),
            max_attempts=self._send_retries + 1,
            giveup=lambda: self._stopped.is_set(),
            name="gossip.send")
        # the retry budget stop() joins against
        self._retry_sleep_budget = self._retrier.worst_case_delay(
            self._send_retries)
        self._my_tls_hash = (_pem_cert_der_hash(client_cert)
                             if client_cert is not None else b"")
        # registry-fed mutex: the comm lock nests inside callers' locks
        # (gossip node, discovery) — an inversion is a real deadlock
        self._lock = RegisteredLock("gossip.comm")
        self._senders: List[RegisteredThread] = []
        self._stopped = threading.Event()
        self._handlers: Dict[str, Handler] = {}
        self._clients: Dict[str, GRPCClient] = {}
        self._queues: Dict[str, GuardedQueue] = {}
        self._tokens: Dict[str, str] = {}        # dst endpoint -> token
        self._nonces: Dict[str, float] = {}      # minted nonce -> expiry
        self._sessions: Dict[str, tuple] = {}    # token -> (pki, tls, exp)
        self.partitioned: set = set()      # honored like InProcNetwork
        self.server = GRPCServer(listen_address,
                                 server_cert_pem=server_cert,
                                 server_key_pem=server_key,
                                 client_root_pem=client_ca)
        host = listen_address.rsplit(":", 1)[0]
        self.listen_endpoint = f"{host}:{self.server.port}"
        self.server.register(*self.SERVICE, MethodKind.UNARY,
                             self._on_message)
        self.server.register(*self.SERVICE_CONNECT, MethodKind.UNARY,
                             self._on_connect)

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
            queues = list(self._queues.values())
            senders, self._senders = self._senders, []
        for q in queues:
            try:
                q.put_nowait(None)
            except Exception as e:
                # a full queue: its sender polls _stopped too
                log.debug("stop sentinel not queued: %r", e)
        for c in clients:
            c.close()
        self.server.stop()
        # every per-destination sender must end: one mid-send against
        # an unresponsive peer may chain a handshake, a send, a NACK
        # re-handshake and a resend (up to ~6 calls, each bounded by
        # send_timeout_s) per attempt, and the retrier's attempts and
        # sleeps — the join budget derives from them
        worst = (6 * self._timeout * (self._send_retries + 1)
                 + self._retry_sleep_budget)
        assert_joined(senders, owner="gossip.comm",
                      timeout=max(15.0, worst + 1.0))

    # -- the network surface ---------------------------------------------
    def register(self, endpoint: str, handler: Handler) -> None:
        with self._lock:
            self._handlers[endpoint] = handler

    def unregister(self, endpoint: str) -> None:
        with self._lock:
            self._handlers.pop(endpoint, None)

    def send(self, src_endpoint: str, src_pki_id: bytes,
             dst_endpoint: str, env_bytes: bytes) -> bool:
        if self._stopped.is_set():
            return False
        if src_endpoint in self.partitioned or \
                dst_endpoint in self.partitioned:
            return False
        with self._lock:
            local = self._handlers.get(dst_endpoint)
        if local is not None:              # same-process shortcut
            local(src_pki_id, env_bytes)
            return True
        payload = json.dumps(
            {"dst": dst_endpoint,
             "pki": base64.b64encode(src_pki_id).decode(),
             "env": base64.b64encode(env_bytes).decode()}).encode()
        q = self._queue_for(dst_endpoint)
        try:
            q.put_nowait(payload)
            return True                    # best-effort enqueue
        except Exception:
            return False                   # full: drop (gossip re-sends)

    # -- internals --------------------------------------------------------
    def _queue_for(self, endpoint: str) -> GuardedQueue:
        with self._lock:
            q = self._queues.get(endpoint)
            if q is None:
                # consumer side pinned to the sender thread: any other
                # thread draining a destination's queue would reorder or
                # steal its traffic — a race, caught at the get
                q = GuardedQueue(self.QUEUE_CAP,
                                 name=f"gossip-send[{endpoint}]")
                self._queues[endpoint] = q
                t = RegisteredThread(target=self._sender,
                                     name=f"gossip-send[{endpoint}]",
                                     structure="gossip.comm",
                                     args=(endpoint, q))
                self._senders.append(t)
                t.start()
            return q

    def _sender(self, endpoint: str, q: GuardedQueue) -> None:
        while not self._stopped.is_set():
            try:
                payload = q.get(timeout=0.5)
            except Exception:
                continue                   # empty: poll _stopped
            if payload is None or self._stopped.is_set():
                return
            try:
                # bounded jittered-backoff retries: a transient failure
                # costs a short retry instead of the message;
                # _attempt_send drops the dead client between attempts
                self._retrier.call(self._attempt_send, endpoint, payload)
            except Exception as e:
                # budget spent: drop (gossip re-sends)
                log.debug("gossip send to %s dropped after retries: %r",
                          endpoint, e)

    def _attempt_send(self, endpoint: str, payload: bytes) -> bytes:
        """One send attempt, NACK re-handshake included; on failure the
        cached client and token are dropped so the next attempt dials
        fresh."""
        try:
            faults.point("gossip.comm.send")
            resp = self._send_one(endpoint, payload)
            if resp == b"NACK" and self._auth is not None:
                # the receiver restarted and lost our session: drop the
                # cached token, re-handshake, retry once
                with self._lock:
                    self._tokens.pop(endpoint, None)
                resp = self._send_one(endpoint, payload)
            return resp
        except Exception:
            with self._lock:
                client = self._clients.pop(endpoint, None)
                self._tokens.pop(endpoint, None)
            if client is not None:
                client.close()
            raise

    def _send_one(self, endpoint: str, payload: bytes) -> bytes:
        if self._auth is not None:
            token = self._token_for(endpoint)
            d = json.loads(payload)
            d["token"] = token
            payload = json.dumps(d).encode()
        return self._client_for(endpoint).unary(
            *self.SERVICE, payload, timeout=self._timeout)

    # -- client side of the handshake -------------------------------------
    def _token_for(self, endpoint: str) -> str:
        with self._lock:
            token = self._tokens.get(endpoint)
        if token is not None:
            return token
        client = self._client_for(endpoint)
        hello = json.loads(client.unary(
            *self.SERVICE_CONNECT, json.dumps({"phase": "hello"}).encode(),
            timeout=self._timeout))
        nonce = base64.b64decode(hello["nonce"])
        sig = self._auth.sign(_HSK_CTX + nonce + self._my_tls_hash)
        resp = json.loads(client.unary(
            *self.SERVICE_CONNECT,
            json.dumps({
                "phase": "auth",
                "nonce": hello["nonce"],
                "identity": base64.b64encode(self._auth.identity).decode(),
                "tls": base64.b64encode(self._my_tls_hash).decode(),
                "sig": base64.b64encode(sig).decode()}).encode(),
            timeout=self._timeout))
        if "token" not in resp:
            raise RuntimeError(f"gossip handshake with {endpoint} "
                               f"refused: {resp.get('error')}")
        token = resp["token"]
        with self._lock:
            self._tokens[endpoint] = token
        return token

    # -- server side of the handshake --------------------------------------
    @staticmethod
    def _peer_cert_hash(context) -> bytes:
        """DER digest of the TLS client certificate presented on this
        connection (b"" without mTLS)."""
        ders = context.auth_context().get("x509_der_cert") or []
        return _der_hash(ders[0]) if ders else b""

    def _on_connect(self, request: bytes, context) -> bytes:
        if self._auth is None:
            return json.dumps({"error": "auth not enabled"}).encode()
        try:
            d = json.loads(request)
            if d.get("phase") == "hello":
                nonce = os.urandom(16)
                with self._lock:
                    now = time.time()
                    self._nonces = {n: exp for n, exp in
                                    self._nonces.items() if exp > now}
                    self._nonces[base64.b64encode(nonce).decode()] = \
                        now + self.NONCE_TTL_S
                return json.dumps(
                    {"nonce": base64.b64encode(nonce).decode()}).encode()
            # phase: auth
            nonce_b64 = d["nonce"]
            with self._lock:
                exp = self._nonces.pop(nonce_b64, None)
            if exp is None or exp < time.time():
                return json.dumps(
                    {"error": "unknown or expired nonce"}).encode()
            identity = base64.b64decode(d["identity"])
            claimed_tls = base64.b64decode(d["tls"])
            sig = base64.b64decode(d["sig"])
            actual_tls = self._peer_cert_hash(context)
            if not actual_tls:
                # no client certificate on this connection: both hashes
                # would be b"" and the binding would pass vacuously,
                # turning session tokens into unbound bearer credentials
                return json.dumps(
                    {"error": "auth requires an mTLS client "
                     "certificate to bind the session to"}).encode()
            if claimed_tls != actual_tls:
                # the signed TLS binding does not match the certificate
                # on this connection: a replayed or stolen handshake
                return json.dumps(
                    {"error": "tls binding mismatch"}).encode()
            pki = self._auth.validate(identity)   # raises on invalid
            nonce = base64.b64decode(nonce_b64)
            if not self._auth.verify(pki, _HSK_CTX + nonce + claimed_tls,
                                     sig):
                return json.dumps(
                    {"error": "bad handshake signature"}).encode()
            token = base64.b64encode(os.urandom(16)).decode()
            now = time.time()
            with self._lock:
                # sessions are TTL'd and capped: every valid MSP member
                # can mint them, so unbounded growth would be a slow DoS
                self._sessions = {t: s for t, s in self._sessions.items()
                                  if s[2] > now}
                while len(self._sessions) >= self.SESSION_CAP:
                    oldest = min(self._sessions,
                                 key=lambda t: self._sessions[t][2])
                    del self._sessions[oldest]
                self._sessions[token] = (pki, actual_tls,
                                         now + self.SESSION_TTL_S)
            return json.dumps({"token": token}).encode()
        except Exception as e:
            return json.dumps({"error": str(e)}).encode()

    def _client_for(self, endpoint: str) -> GRPCClient:
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("network stopped")
            client = self._clients.get(endpoint)
            if client is None:
                ca, cert, key = self._client_tls
                client = GRPCClient(endpoint, server_root_pem=ca,
                                    client_cert_pem=cert,
                                    client_key_pem=key)
                self._clients[endpoint] = client
            return client

    def _on_message(self, request: bytes, context) -> bytes:
        try:
            d = json.loads(request)
            claimed_pki = base64.b64decode(d["pki"])
            env = base64.b64decode(d["env"])
        except Exception as e:
            log.debug("malformed inbound gossip message: %r", e)
            return b""
        if self._auth is not None:
            now = time.time()
            with self._lock:
                session = self._sessions.get(d.get("token", ""))
            if session is None or session[2] < now:
                # an unknown or expired token (the receiver restarted and
                # lost the session): NACK, so the sender re-handshakes
                return b"NACK"
            auth_pki, bound_tls, _exp = session
            # the token is bound to the TLS client certificate it was
            # minted under: a stolen token dies with its session
            if bound_tls != self._peer_cert_hash(context):
                return b""
            # a claimed sender other than the connection's authenticated
            # identity is the confusion the handshake exists to stop
            if claimed_pki != auth_pki:
                return b""
        with self._lock:
            handler = self._handlers.get(d.get("dst"))
        if handler is not None:
            try:
                handler(claimed_pki, env)
            except Exception as e:
                # the receiver's failure ends here, as the reference's:
                # the message is lost and anti-entropy repairs it
                log.warning("inbound gossip dispatch failed: %r", e)
        return b""


class GossipComm:
    """One node's sending surface (reference: comm_impl.go Send)."""

    def __init__(self, endpoint: str, pki_id: bytes, network, signer):
        self.endpoint = endpoint
        self.pki_id = pki_id
        self._network = network
        self._signer = signer

    def send(self, dst_endpoint: str, msg: m.GossipMessage) -> bool:
        env = sign_message(msg, self._signer)
        return self._network.send(self.endpoint, self.pki_id,
                                  dst_endpoint, env.encode())

    def sign_once(self, msg: m.GossipMessage) -> bytes:
        """Pre-sign a message into its envelope bytes: the relay signs
        each frame once and ships the same envelope to every tree child
        (degree sends must not mean degree signatures)."""
        return sign_message(msg, self._signer).encode()

    def send_signed(self, dst_endpoint: str, env_bytes: bytes) -> bool:
        """Ship pre-signed envelope bytes (from sign_once)."""
        return self._network.send(self.endpoint, self.pki_id,
                                  dst_endpoint, env_bytes)

    def broadcast(self, dst_endpoints, msg: m.GossipMessage) -> int:
        got = 0
        for dst in dst_endpoints:
            if self.send(dst, msg):
                got += 1
        return got
