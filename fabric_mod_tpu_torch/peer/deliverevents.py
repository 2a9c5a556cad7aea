"""Client-facing event deliver service: Deliver / DeliverFiltered, in
process.

The port's copy of fabric_mod_tpu/peer/deliverevents.py (reference:
core/peer/deliverevents.go — `Deliver` at :255 streaming full blocks,
`DeliverFiltered` at :240 streaming filtered blocks).  The server's
seek checks (`_check_request`), its frame loop (`_frames`) and the
session ACL re-check over the fan-out engine's `AclGroups` are the
reference's (:120-258); the gRPC registration is not: a stream is the
in-process call `handle(filtered, request_iter)`, which yields the
encoded DeliverResponse messages the reference's handler yields, and
the client goes over a callable transport (`server.call` or anything
with its signature) instead of a channel.  The gRPC registration comes
with the gRPC transport (`comm/`).

Server side: seek semantics over the peer ledger (committed blocks,
whose metadata carries the validator's txflags), gated per stream by
the channel ACLs `event/Block` / `event/FilteredBlock`
(peer/aclmgmt.py), on the shared per-block fan-out engine
(peer/fanout.py).  A stream stops when its CancellationEvent is set,
when its deadline passes at the tip (TimeoutError, the gRPC deadline's
stand-in) or when the server stops.

Client side: `EventDeliverClient` signs SeekInfo envelopes and exposes
`wait_for_tx` — scan filtered blocks until a txid appears and return
its validation code.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Iterator, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import CancellationEvent
from fabric_mod_tpu_torch.peer.fanout import FanoutEngine, filtered_block
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.protos.protoutil import SignedData

__all__ = ["EventDeliverServer", "EventDeliverClient", "EventStreamError",
           "filtered_block", "make_signed_seek_envelope"]

METHODS = {"Deliver": False, "DeliverFiltered": True}
# the reference's FABRIC_MOD_TPU_DELIVER_STREAMS default
MAX_STREAMS = 40


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class EventDeliverServer:
    """One channel's event service over `ledger` (a KvLedger: `height`,
    `height_changed`, `get_block_by_number`) gated by `acl` (a peer
    ACLProvider).  Each stream's first envelope is checked against
    event/Block or event/FilteredBlock before any block flows; session
    re-checks after admission are batched per (resource, creator)
    group by the fan-out engine.  `max_streams` is the admission cap
    (the reference's FABRIC_MOD_TPU_DELIVER_STREAMS, default 40): past
    it a stream gets SERVICE_UNAVAILABLE."""

    def __init__(self, channel_id: str, ledger, acl,
                 max_streams: int = MAX_STREAMS):
        self._channel_id = channel_id
        self._ledger = ledger
        self._acl = acl
        self._closing = threading.Event()
        self._streams = threading.Semaphore(max_streams)
        self._fanout = FanoutEngine(channel_id, ledger, acl)
        self.active_streams = 0
        self.rejected_streams = 0
        self._count_lock = threading.Lock()

    @property
    def fanout(self) -> FanoutEngine:
        return self._fanout

    def stop(self) -> None:
        # flag the close, then the notifier close wakes every stream
        # parked at the tip
        self._closing.set()
        self._fanout.close()

    def call(self, method: str, request_iter,
             stop_event: Optional[CancellationEvent] = None,
             timeout_s: Optional[float] = None) -> Iterator[bytes]:
        """The in-process transport: `method` is "Deliver" or
        "DeliverFiltered"."""
        if method not in METHODS:
            raise ValueError(f"unknown deliver method {method!r}")
        return self.handle(METHODS[method], request_iter, stop_event,
                           timeout_s)

    # -- stream handler --------------------------------------------------

    def handle(self, filtered: bool, request_iter,
               stop_event: Optional[CancellationEvent] = None,
               timeout_s: Optional[float] = None) -> Iterator[bytes]:
        """One stream: each request envelope in `request_iter` is a
        seek, answered by its frames and then a status message."""
        form = "filtered" if filtered else "full"
        if not self._streams.acquire(blocking=False):
            with self._count_lock:
                self.rejected_streams += 1
            yield m.DeliverResponse(
                status=m.Status.SERVICE_UNAVAILABLE).encode()
            return
        with self._count_lock:
            self.active_streams += 1
        stop_event = stop_event if stop_event is not None \
            else CancellationEvent()
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        try:
            for raw in request_iter:
                status, seek, recheck = self._check_request(raw, filtered)
                if seek is None:
                    yield m.DeliverResponse(status=status).encode()
                    return
                final = {"status": m.Status.SUCCESS}
                yield from self._frames(form, seek, stop_event, final,
                                        recheck, deadline)
                yield m.DeliverResponse(status=final["status"]).encode()
        finally:
            self._streams.release()
            with self._count_lock:
                self.active_streams -= 1

    def _check_request(self, raw: bytes, filtered: bool
                       ) -> Tuple[int, Optional[m.SeekInfo],
                                  Optional[Callable[..., None]]]:
        try:
            env = m.Envelope.decode(raw)
            payload = protoutil.unmarshal_envelope_payload(env)
            ch = m.ChannelHeader.decode(payload.header.channel_header)
            sh = m.SignatureHeader.decode(payload.header.signature_header)
            seek = m.SeekInfo.decode(payload.data)
        except Exception:
            return m.Status.BAD_REQUEST, None, None
        # only DELIVER_SEEK_INFO envelopes are seek requests (the
        # reference's header-type check, deliver/deliver.go)
        if ch.type != m.HeaderType.DELIVER_SEEK_INFO:
            return m.Status.BAD_REQUEST, None, None
        if ch.channel_id != self._channel_id:
            return m.Status.NOT_FOUND, None, None
        resource = "event/FilteredBlock" if filtered else "event/Block"
        sd = SignedData(data=env.payload, identity=sh.creator,
                        signature=env.signature)
        # the config sequence is read BEFORE the admission check, so a
        # config update landing between the two is re-checked later
        seq0 = self._fanout.acl_groups.sequence()
        try:
            self._acl.check_acl(resource, [sd])
        except Exception:
            return m.Status.FORBIDDEN, None, None
        # the session re-check (reference: common/deliver/deliver.go
        # :157-199 SessionAC), batched per (resource, creator) group
        sess = self._fanout.acl_groups.join(resource, sd, seq0)
        return m.Status.SUCCESS, seek, sess.recheck

    def _frames(self, form: str, seek: m.SeekInfo,
                stop_event: CancellationEvent, final: dict,
                recheck=None, deadline: Optional[float] = None
                ) -> Iterator[bytes]:
        """BLOCK_UNTIL_READY streams wait at the tip until cancelled,
        the server closes or the deadline passes (TimeoutError);
        FAIL_IF_NOT_READY at a missing block sets final["status"] =
        NOT_FOUND.  Before each frame the session re-check runs — forced
        when the frame is a config block — and a revoked subscriber gets
        FORBIDDEN before the next frame, fail-closed."""
        engine = self._fanout
        h = self._ledger.height
        num = protoutil.seek_number(seek.start, h, newest_tip=True) or 0
        stop = protoutil.seek_number(seek.stop, h, newest_tip=False)
        engine.attach(form)
        waiter = engine.notifier.waiter()
        unhook = stop_event.on_set(waiter.cancel)
        try:
            while stop is None or num <= stop:
                if stop_event.is_set() or self._closing.is_set():
                    return
                frame = engine.get_frame(form, num)
                if frame is not None:
                    if recheck is not None:
                        try:
                            recheck(force=frame.is_config,
                                    config_mark=num)
                        except Exception:
                            final["status"] = m.Status.FORBIDDEN
                            return
                    yield frame.payload
                    num += 1
                    continue
                if seek.behavior == m.SeekBehavior.FAIL_IF_NOT_READY:
                    final["status"] = m.Status.NOT_FOUND
                    return
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("deliver stream deadline exceeded")
                got = engine.notifier.wait_above(num, waiter,
                                                 timeout_s=remaining)
                if got == "closed":
                    return
        finally:
            unhook()
            engine.notifier.release(waiter)
            engine.detach(form)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def make_signed_seek_envelope(channel_id: str, start: int,
                              stop: Optional[int], signer,
                              behavior: Optional[int] = None
                              ) -> m.Envelope:
    """A SeekInfo envelope with a real creator and signature (the event
    service enforces ACLs)."""
    stop_pos = (m.SeekPosition(specified=m.SeekSpecified(number=stop))
                if stop is not None else None)
    seek = m.SeekInfo(
        start=m.SeekPosition(specified=m.SeekSpecified(number=start)),
        stop=stop_pos,
        behavior=(m.SeekBehavior.BLOCK_UNTIL_READY
                  if behavior is None else behavior))
    ch = protoutil.make_channel_header(
        m.HeaderType.DELIVER_SEEK_INFO, channel_id)
    sh = protoutil.make_signature_header(signer.serialize(),
                                         protoutil.new_nonce())
    payload = protoutil.make_payload(ch, sh, seek.encode())
    return protoutil.sign_envelope(payload, signer)


class EventDeliverClient:
    """Client over the peer event service.  `transport(method,
    request_iter, stop_event=None, timeout_s=None)` returns the stream's
    encoded responses (`EventDeliverServer.call`)."""

    def __init__(self, transport, channel_id: str, signer):
        self._transport = transport
        self._channel_id = channel_id
        self._signer = signer

    def _stream(self, method: str, start: int, stop: Optional[int],
                timeout_s: Optional[float], stop_event):
        env = make_signed_seek_envelope(self._channel_id, start, stop,
                                        self._signer)
        return self._transport(method, iter([env.encode()]),
                               stop_event=stop_event, timeout_s=timeout_s)

    def blocks(self, start: int = 0, stop: Optional[int] = None,
               timeout_s: Optional[float] = None,
               stop_event: Optional[CancellationEvent] = None
               ) -> Iterator[m.Block]:
        for raw in self._stream("Deliver", start, stop, timeout_s,
                                stop_event):
            resp = m.DeliverResponse.decode(raw)
            if resp.block is not None:
                yield resp.block
            else:
                self._raise_unless_ok(resp.status)
                return

    def filtered_blocks(self, start: int = 0, stop: Optional[int] = None,
                        timeout_s: Optional[float] = None,
                        stop_event: Optional[CancellationEvent] = None
                        ) -> Iterator[m.FilteredBlock]:
        for raw in self._stream("DeliverFiltered", start, stop, timeout_s,
                                stop_event):
            resp = m.DeliverResponse.decode(raw)
            if resp.filtered_block is not None:
                yield resp.filtered_block
            else:
                self._raise_unless_ok(resp.status)
                return

    @staticmethod
    def _raise_unless_ok(status: int) -> None:
        if status != m.Status.SUCCESS:
            raise EventStreamError(status)

    def wait_for_tx(self, txid: str, start: int = 0,
                    timeout_s: float = 30.0) -> int:
        """Block until `txid` appears in a committed block; return its
        TxValidationCode (the SDK's commit listener over
        DeliverFiltered).  The deadline bounds the wait."""
        try:
            for fb in self.filtered_blocks(start=start,
                                           timeout_s=timeout_s):
                for ftx in fb.filtered_transactions:
                    if ftx.txid == txid:
                        return ftx.tx_validation_code
        except TimeoutError:
            raise TimeoutError(
                f"tx {txid} not committed within {timeout_s}s") from None
        raise TimeoutError(f"tx {txid} not seen before stream end")


class EventStreamError(Exception):
    def __init__(self, status: int):
        super().__init__(f"event deliver stream refused: status {status}")
        self.status = status
