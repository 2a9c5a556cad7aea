"""Cluster communication: the Raft transport over the wire.

The port's copy of fabric_mod_tpu/orderer/cluster.py (reference:
orderer/common/cluster/comm.go — the orderer-to-orderer `Cluster/Step`
RPC carrying consensus messages and submit forwarding, with
per-destination send queues so one dead peer never stalls the consensus
thread, and TLS-pinned membership through the comm layer's mTLS).

`GRPCRaftTransport` implements the RaftTransport seam
(orderer/raft.py:117, register/send) that `RaftNode` and `RaftChain`
consume in process: messages are serialized as JSON (bytes base64'd,
never pickle: peers are remote) byte for byte as the reference's, unary
`Cluster/Step` calls deliver them, and a bounded queue and a sender
thread per destination absorb slow or dead peers (drops on overflow;
Raft tolerates message loss).
"""
from __future__ import annotations

import base64
import json
import queue
import threading
from typing import Callable, Dict, Optional

from fabric_mod_tpu_torch.comm.grpc_comm import (GRPCClient, GRPCServer,
                                                 MethodKind)
from fabric_mod_tpu_torch.concurrency.locks import RegisteredLock
from fabric_mod_tpu_torch.concurrency.threads import (RegisteredThread,
                                                      assert_joined)
from fabric_mod_tpu_torch.observability.logging import get_logger
from fabric_mod_tpu_torch.orderer import raft, raftchain

log = get_logger("orderer.cluster")


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def encode_msg(msg) -> bytes:
    """Raft/chain message -> wire JSON."""
    if isinstance(msg, raft.RequestVote):
        d = {"t": "rv", "term": msg.term, "candidate": msg.candidate,
             "lli": msg.last_log_index, "llt": msg.last_log_term}
    elif isinstance(msg, raft.VoteReply):
        d = {"t": "vr", "term": msg.term, "voter": msg.voter,
             "granted": msg.granted}
    elif isinstance(msg, raft.AppendEntries):
        d = {"t": "ae", "term": msg.term, "leader": msg.leader,
             "pi": msg.prev_index, "pt": msg.prev_term,
             "lc": msg.leader_commit,
             "entries": [[t, _b64(data)] for t, data in msg.entries]}
    elif isinstance(msg, raft.AppendReply):
        d = {"t": "ar", "term": msg.term, "follower": msg.follower,
             "success": msg.success, "mi": msg.match_index}
    elif isinstance(msg, raft.InstallSnapshot):
        d = {"t": "is", "term": msg.term, "leader": msg.leader,
             "li": msg.last_index, "lt": msg.last_term,
             "data": _b64(msg.data)}
    elif isinstance(msg, raftchain._Submit):
        d = {"t": "submit", "env": _b64(msg.env_bytes),
             "cfg": msg.is_config, "seq": msg.config_seq}
    else:
        raise TypeError(f"unknown cluster message {type(msg)!r}")
    return json.dumps(d).encode()


def decode_msg(raw: bytes):
    d = json.loads(raw)
    t = d["t"]
    if t == "rv":
        return raft.RequestVote(d["term"], d["candidate"], d["lli"],
                                d["llt"])
    if t == "vr":
        return raft.VoteReply(d["term"], d["voter"], d["granted"])
    if t == "ae":
        return raft.AppendEntries(
            d["term"], d["leader"], d["pi"], d["pt"],
            [(t_, _unb64(b)) for t_, b in d["entries"]], d["lc"])
    if t == "ar":
        return raft.AppendReply(d["term"], d["follower"], d["success"],
                                d["mi"])
    if t == "is":
        return raft.InstallSnapshot(d["term"], d["leader"], d["li"],
                                    d["lt"], _unb64(d["data"]))
    if t == "submit":
        return raftchain._Submit(_unb64(d["env"]), d["cfg"], d["seq"])
    raise ValueError(f"unknown cluster message type {t!r}")


class GRPCRaftTransport:
    """RaftTransport over the wire (reference: cluster comm.go).

    `peers`: {base_node_id: "host:port"} including this node.  Targets
    named "<id>" or "<id>:chain" route to the peer owning <id>; local
    targets bypass the network.  TLS material (PEM bytes) makes both
    the server and the dials mutually authenticated."""

    STEP = ("Cluster", "Step")
    QUEUE_CAP = 256
    SEND_TIMEOUT_S = 2.0

    def __init__(self, node_id: str, peers: Dict[str, str],
                 listen_address: Optional[str] = None,
                 server_cert: Optional[bytes] = None,
                 server_key: Optional[bytes] = None,
                 client_ca: Optional[bytes] = None,
                 client_cert: Optional[bytes] = None,
                 client_key: Optional[bytes] = None):
        self.node_id = node_id
        self._peers = dict(peers)
        self._handlers: Dict[str, Callable] = {}
        self._lock = RegisteredLock("orderer.cluster._lock")
        self._stopped = threading.Event()
        self._client_tls = (client_ca, client_cert, client_key)
        # per-destination bounded queues + sender threads: a dead peer
        # blocks its own queue only, never the raft FSM thread
        self._queues: Dict[str, "queue.Queue"] = {}
        self._senders: Dict[str, RegisteredThread] = {}
        self._clients: Dict[str, GRPCClient] = {}
        self.server = GRPCServer(
            listen_address or peers[node_id],
            server_cert_pem=server_cert, server_key_pem=server_key,
            client_root_pem=client_ca)
        self.server.register(*self.STEP, MethodKind.UNARY, self._on_step)

    def set_peer_address(self, node_id: str, address: str) -> None:
        """Fill in a peer's dial address after its server bound (test
        topologies bind port 0 first, then exchange real ports)."""
        with self._lock:
            self._peers[node_id] = address
            client = self._clients.pop(node_id, None)
        if client is not None:
            client.close()

    @property
    def listen_port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        """Stop sending and serving; joins every sender thread and the
        server's threads (idempotent)."""
        self._stopped.set()
        with self._lock:
            queues = list(self._queues.values())
            clients = list(self._clients.values())
            senders = list(self._senders.values())
            self._clients.clear()
        for q in queues:
            try:
                q.put_nowait(None)
            except queue.Full:
                pass                       # the sender polls _stopped too
        for client in clients:
            client.close()
        self.server.stop()
        assert_joined(senders, owner="orderer.cluster",
                      timeout=self.SEND_TIMEOUT_S + 5.0)

    # -- the RaftTransport surface ---------------------------------------
    def register(self, target: str, handler: Callable) -> None:
        with self._lock:
            self._handlers[target] = handler

    def send(self, src: str, dst: str, msg) -> None:
        if self._stopped.is_set():
            return                         # no new queues after stop
        base = dst.partition(":")[0]
        if base == self.node_id:
            self._deliver(src, dst, encode_msg(msg))
            return
        if base not in self._peers:
            return
        q = self._queue_for(base)
        try:
            q.put_nowait((src, dst, encode_msg(msg)))
        except queue.Full:
            pass                           # drop: raft re-sends

    # -- internals --------------------------------------------------------
    def _deliver(self, src: str, dst: str, raw: bytes) -> None:
        with self._lock:
            handler = self._handlers.get(dst)
        if handler is None:
            return
        try:
            handler(src, decode_msg(raw))
        except Exception as e:
            log.debug("cluster step handler for %s failed: %r", dst, e)

    def _queue_for(self, base: str) -> "queue.Queue":
        with self._lock:
            q = self._queues.get(base)
            if q is None:
                q = queue.Queue(self.QUEUE_CAP)
                self._queues[base] = q
                t = RegisteredThread(target=self._sender, args=(base, q),
                                     name=f"cluster-sender[{base}]",
                                     structure="orderer.cluster")
                self._senders[base] = t
                t.start()
            return q

    def _sender(self, base: str, q: "queue.Queue") -> None:
        while not self._stopped.is_set():
            try:
                # bounded wait so a full queue at stop() (dropped
                # sentinel) still terminates promptly
                item = q.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None or self._stopped.is_set():
                return
            src, dst, raw = item
            try:
                client = self._client_for(base)
                client.unary(*self.STEP, json.dumps(
                    {"src": src, "dst": dst,
                     "msg": _b64(raw)}).encode(),
                    timeout=self.SEND_TIMEOUT_S)
            except Exception as e:
                # dead peer: drop and forget the cached channel so the
                # next attempt re-dials
                log.debug("cluster step to %s failed: %r", base, e)
                with self._lock:
                    client = self._clients.pop(base, None)
                if client is not None:
                    client.close()

    def _client_for(self, base: str) -> GRPCClient:
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("transport stopped")
            client = self._clients.get(base)
            if client is None:
                ca, cert, key = self._client_tls
                client = GRPCClient(self._peers[base],
                                    server_root_pem=ca,
                                    client_cert_pem=cert,
                                    client_key_pem=key)
                self._clients[base] = client
            return client

    def _on_step(self, request: bytes, context) -> bytes:
        try:
            d = json.loads(request)
            self._deliver(d["src"], d["dst"], _unb64(d["msg"]))
        except Exception as e:
            log.debug("malformed cluster step request: %r", e)
        return b""
