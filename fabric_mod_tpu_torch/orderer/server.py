"""The orderer's RPC surface: AtomicBroadcast.Broadcast/Deliver.

The port's copy of fabric_mod_tpu/orderer/server.py (reference:
orderer/common/server — NewServer at server.go:210 registering
AtomicBroadcast over internal/pkg/comm's mTLS server; broadcast.go:66
Handle and common/deliver/deliver.go:157 Handle are the two stream
loops).

Wire contract: envelopes, seek infos and responses are this framework's
deterministic encodings travelling as byte payloads of comm/grpc_comm's
generic handlers.
"""
from __future__ import annotations

from typing import Iterator, Optional

from fabric_mod_tpu_torch.comm.grpc_comm import GRPCServer, MethodKind
from fabric_mod_tpu_torch.concurrency import CancellationEvent
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.orderer.admission import ResourceExhaustedError
from fabric_mod_tpu_torch.orderer.broadcast import Broadcast, BroadcastError
from fabric_mod_tpu_torch.orderer.consensus import NotLeaderError
from fabric_mod_tpu_torch.orderer.deliver import DeliverService
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

SERVICE = "orderer.AtomicBroadcast"


class OrdererServer:
    """Binds a Registrar to an RPC listener."""

    def __init__(self, registrar: Registrar, address: str = "127.0.0.1:0",
                 server_cert_pem: Optional[bytes] = None,
                 server_key_pem: Optional[bytes] = None,
                 client_root_pem: Optional[bytes] = None):
        self._registrar = registrar
        self._broadcast = Broadcast(registrar)
        self._grpc = GRPCServer(address, server_cert_pem,
                                server_key_pem, client_root_pem)
        self.port = self._grpc.port
        self._grpc.register(SERVICE, "Broadcast",
                            MethodKind.STREAM_STREAM, self._handle_broadcast)
        self._grpc.register(SERVICE, "Deliver",
                            MethodKind.STREAM_STREAM, self._handle_deliver)

    def start(self) -> None:
        self._grpc.start()

    def stop(self, grace: float = 1.0) -> None:
        """`grace=0` aborts in-flight streams at once (a crash); the
        default drains them briefly."""
        self._grpc.stop(grace)

    # -- Broadcast stream (reference: broadcast.go:66) -------------------
    def _handle_broadcast(self, request_iter, context) -> Iterator[bytes]:
        # cross-process trace stitching: every envelope of this stream
        # parents under the client's context carried as stream metadata
        parent = tracing.extract(context.invocation_metadata()) \
            if tracing.armed() else None
        for raw in request_iter:
            try:
                env = m.Envelope.decode(raw)
                with tracing.span("broadcast.handle", parent=parent,
                                  bytes=len(raw)):
                    self._broadcast.submit(env)
                resp = m.BroadcastResponse(status=m.Status.SUCCESS)
            except BroadcastError as e:
                resp = m.BroadcastResponse(
                    status=m.Status.BAD_REQUEST, info=str(e))
            except NotLeaderError as e:
                # leaderless past the retry budget: retryable, with the
                # best leader hint (reference: etcdraft Submit ->
                # SERVICE_UNAVAILABLE + redirect info)
                hint = (f"; try {e.leader_hint}"
                        if e.leader_hint else "")
                resp = m.BroadcastResponse(
                    status=m.Status.SERVICE_UNAVAILABLE,
                    info=f"no leader: retry{hint}")
            except ResourceExhaustedError as e:
                # admission shed: typed and retryable, with the server's
                # retry-after hint the broadcast client parses
                resp = m.BroadcastResponse(
                    status=m.Status.RESOURCE_EXHAUSTED,
                    info=f"resource exhausted ({e.reason}): "
                         f"retry_after={e.retry_after_s:.3f}")
            except Exception as e:
                resp = m.BroadcastResponse(
                    status=m.Status.INTERNAL_SERVER_ERROR, info=str(e))
            yield resp.encode()

    # -- Deliver stream (reference: deliver.go:157-199) ------------------
    def _handle_deliver(self, request_iter, context) -> Iterator[bytes]:
        for raw in request_iter:
            try:
                env = m.Envelope.decode(raw)
                payload = protoutil.unmarshal_envelope_payload(env)
                ch = m.ChannelHeader.decode(payload.header.channel_header)
                seek = m.SeekInfo.decode(payload.data)
            except Exception:
                yield m.DeliverResponse(
                    status=m.Status.BAD_REQUEST).encode()
                return
            support = self._registrar.get_chain(ch.channel_id)
            if support is None:
                yield m.DeliverResponse(
                    status=m.Status.NOT_FOUND).encode()
                return
            svc = DeliverService(support)
            h = support.store.height
            start = protoutil.seek_number(seek.start, h, newest_tip=True)
            stop = protoutil.seek_number(seek.stop, h, newest_tip=False)
            # the client going away (cancel, a lost connection, the
            # server's stop) sets the stream's stop event
            stop_event = CancellationEvent()
            context.add_callback(stop_event.set)
            for block in svc.blocks(start, stop=stop,
                                    stop_event=stop_event,
                                    timeout_s=30.0):
                yield m.DeliverResponse(block=block).encode()
            yield m.DeliverResponse(status=m.Status.SUCCESS).encode()


def make_seek_envelope(channel_id: str, start: int,
                       stop: Optional[int] = None) -> m.Envelope:
    """Client-side SeekInfo envelope (reference: the deliver client's
    seekInfo construction in blocksprovider)."""
    stop_pos = (m.SeekPosition(specified=m.SeekSpecified(number=stop))
                if stop is not None else None)
    seek = m.SeekInfo(
        start=m.SeekPosition(specified=m.SeekSpecified(number=start)),
        stop=stop_pos,
        behavior=m.SeekBehavior.BLOCK_UNTIL_READY)
    ch = protoutil.make_channel_header(
        m.HeaderType.DELIVER_SEEK_INFO, channel_id)
    sh = protoutil.make_signature_header(b"", protoutil.new_nonce())
    payload = protoutil.make_payload(ch, sh, seek.encode())
    return m.Envelope(payload=payload.encode())
