"""Gossip transport: authenticated peer-to-peer message passing, in
process.

The port's copy of fabric_mod_tpu/gossip/comm.py `InProcNetwork` (:70)
and `GossipComm` (:510) (reference: gossip/comm/comm_impl.go — every
delivered message is attributed to the sender that the authenticated
handshake of :411 established; here attribution is by sender PKI-ID).
The gRPC transport (`GRPCGossipNetwork`, `GossipAuth`) stays out with
comm/.  `sign_once` and `send_signed` (reference :526, :534) are the
dissemination relay's pre-signed sends: one signature per frame, the
same envelope bytes to every tree child.

`InProcNetwork.send` runs the receiver's handler on the sender's thread.
The reference answers any exception of the handler with "not delivered";
here a handler answers the protocol's own rejections itself (a message
that does not decode or verify is dropped inside `GossipNode`), and
anything else it raises — a device error of the verifier among them —
propagates to the sender.
"""
from __future__ import annotations

from typing import Callable, Dict

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.gossip.protoext import sign_message
from fabric_mod_tpu_torch.protos import messages as m

Handler = Callable[[bytes, bytes], None]     # (src_pki_id, envelope bytes)


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


class GossipComm:
    """One node's sending surface (reference: comm_impl.go Send)."""

    def __init__(self, endpoint: str, pki_id: bytes,
                 network: InProcNetwork, signer):
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
