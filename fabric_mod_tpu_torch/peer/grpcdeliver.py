"""The peer side's deliver source and broadcast client over the wire.

The port's copy of fabric_mod_tpu/peer/grpcdeliver.py (reference:
internal/pkg/peer/blocksprovider — the deliver stream client — and the
broadcast client the CLI uses).

`GrpcDeliverSource` has the same `blocks()` generator shape as the
in-process DeliverService, so DeliverClient (with its MCS verification
and pipelined commit) does not depend on the transport.

`GrpcBroadcaster` is the ingress counterpart, overload-aware: a
RESOURCE_EXHAUSTED answer (an admission shed, orderer/admission.py) is
typed client-side and, with a `retrier` (utils/retry.Retrier), retried
no sooner than the server's retry-after hint; a SERVICE_UNAVAILABLE
answer carrying a leader hint re-dials the hinted consenter through
`redial` before it spends any backoff.
"""
from __future__ import annotations

import os
import queue
import re
import threading
import time
from typing import Callable, Iterator, Optional

from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient, RpcError
from fabric_mod_tpu_torch.concurrency.locks import RegisteredLock
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.observability.logging import get_logger
from fabric_mod_tpu_torch.orderer.server import SERVICE, make_seek_envelope
from fabric_mod_tpu_torch.peer.deliverclient import DeliverDisconnected
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils.retry import Retrier

log = get_logger("peer.grpcdeliver")


class GrpcDeliverSource:
    def __init__(self, client: GRPCClient, channel_id: str):
        self._client = client
        self._channel_id = channel_id

    def blocks(self, start: int = 0, stop: Optional[int] = None,
               stop_event: Optional[threading.Event] = None,
               timeout_s: float = 30.0) -> Iterator[m.Block]:
        seek = make_seek_envelope(self._channel_id, start, stop)
        stream = self._client.stream_stream(
            SERVICE, "Deliver", iter([seek.encode()]))
        try:
            for raw in stream:
                if stop_event is not None and stop_event.is_set():
                    break
                resp = m.DeliverResponse.decode(raw)
                if resp.block is not None:
                    yield resp.block
                else:
                    return                 # terminal status
        except RpcError as e:
            if stop_event is not None and stop_event.is_set():
                return                     # our own cancel, clean end
            # a single-endpoint source: a dropped stream is typed (the
            # caller stamps the committed height) instead of ending
            # silently as if the seek range were served
            raise DeliverDisconnected(
                f"deliver stream dropped: {e!r}") from e
        finally:
            stream.cancel()


class BroadcastClientError(RuntimeError):
    """Typed broadcast rejection: `status`/`info` carry the orderer's
    answer."""

    def __init__(self, msg: str, status: int = 0, info: str = ""):
        super().__init__(msg)
        self.status = status
        self.info = info


class BroadcastUnavailable(BroadcastClientError):
    """SERVICE_UNAVAILABLE (no leader); `leader_hint` is the consenter
    id the orderer suggested, or None."""

    def __init__(self, msg: str, info: str = "",
                 leader_hint: Optional[str] = None):
        super().__init__(msg, m.Status.SERVICE_UNAVAILABLE, info)
        self.leader_hint = leader_hint


class BroadcastResourceExhausted(BroadcastClientError):
    """RESOURCE_EXHAUSTED (admission shed); `retry_after_s` is the
    server's backoff hint."""

    def __init__(self, msg: str, info: str = "",
                 retry_after_s: float = 0.25):
        super().__init__(msg, m.Status.RESOURCE_EXHAUSTED, info)
        self.retry_after_s = retry_after_s


def _parse_leader_hint(info: str) -> Optional[str]:
    got = re.search(r"\btry (\S+)", info or "")
    return got.group(1) if got else None


def _parse_retry_after(info: str, default: float = 0.25) -> float:
    got = re.search(r"\bretry_after=([0-9.]+)", info or "")
    try:
        return float(got.group(1)) if got else default
    except ValueError:
        return default


class GrpcBroadcaster:
    """Streaming broadcast client: submit() sends an envelope and
    returns when the orderer acknowledges it (reference: the broadcast
    client of internal/pkg and the peer CLI).

    `retrier`: retries RESOURCE_EXHAUSTED answers, sleeping at least
    the server's retry-after hint on top of its own backoff; None (the
    default) raises the first typed answer.  `redial(consenter_id) ->
    GRPCClient` follows leader redirects: a SERVICE_UNAVAILABLE answer
    naming a leader re-dials it and resubmits at once, without spending
    retry budget (redirect-dialed clients are owned and closed by this
    object).  The per-stream send queue is bounded (`queue_cap`), so a
    wedged stream raises a typed error instead of buffering without
    end."""

    _MAX_REDIRECTS = 3                     # per submit() call

    def __init__(self, client: GRPCClient,
                 retrier: Optional[Retrier] = None,
                 redial: Optional[Callable[[str], GRPCClient]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 queue_cap: int = 1024):
        self._retrier = retrier
        self._redial = redial
        self._sleep = sleep
        self._queue_cap = queue_cap
        self._lock = RegisteredLock("peer.grpcdeliver._lock")
        self._owned: list = []             # redirect-dialed clients
        self._hint_wait = 0.0              # pending retry-after hint
        self.trace_ctx = None              # set when the tracer is armed
        self._open(client)

    def _open(self, client: GRPCClient) -> None:
        self._client = client
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=self._queue_cap)
        # cross-process stitching: with the tracer armed the stream's
        # metadata carries this client's trace context, and the
        # orderer's broadcast handler parents its spans under it
        self._trace_md = tracing.inject(self._trace_root())
        kw = {"metadata": self._trace_md} \
            if self._trace_md is not None else {}
        self._resps = client.stream_stream(
            SERVICE, "Broadcast", iter(self._q.get, None), **kw)

    def _trace_root(self):
        """The stream's carrier context: the caller's current span if
        one is live, else a fresh per-stream root."""
        if not tracing.armed():
            return None
        ctx = tracing.current_ctx()
        if ctx is None:
            ctx = tracing.TraceContext(tracing.new_trace_id(),
                                       os.urandom(4).hex())
        self.trace_ctx = ctx
        return ctx

    def _reconnect(self, client: GRPCClient) -> None:
        """Swap streams (the caller holds the lock): end the old stream;
        redirect-owned clients are closed, the caller's original client
        stays theirs to close."""
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._resps.cancel()
        if self._client in self._owned:
            self._owned.remove(self._client)
            self._client.close()
        self._owned.append(client)
        self._open(client)

    def submit(self, env: m.Envelope) -> None:
        """Raises BroadcastClientError (typed by status) when the
        orderer rejects; with a `retrier`, RESOURCE_EXHAUSTED answers
        are retried within its budget before they surface."""
        raw = env.encode()
        with self._lock:
            self._hint_wait = 0.0
            if self._retrier is None:
                self._submit_once(raw)
            else:
                self._retrier.call(self._submit_once, raw)

    def _submit_once(self, raw: bytes, redirects: int = 0) -> None:
        hint, self._hint_wait = self._hint_wait, 0.0
        if hint > 0.0:
            # the server's retry-after on top of the retrier's own
            # backoff: a retrying client never hammers a shedding node
            self._sleep(hint)
        try:
            self._q.put_nowait(raw)
        except queue.Full:
            raise BroadcastResourceExhausted(
                f"local broadcast queue full ({self._queue_cap})",
                retry_after_s=0.25) from None
        resp = m.BroadcastResponse.decode(next(self._resps))
        if resp.status == m.Status.SUCCESS:
            return
        if resp.status == m.Status.RESOURCE_EXHAUSTED:
            retry_after = _parse_retry_after(resp.info)
            self._hint_wait = retry_after
            raise BroadcastResourceExhausted(
                f"broadcast rejected: {resp.status} {resp.info}",
                info=resp.info, retry_after_s=retry_after)
        if resp.status == m.Status.SERVICE_UNAVAILABLE:
            lead = _parse_leader_hint(resp.info)
            if lead is not None and self._redial is not None \
                    and redirects < self._MAX_REDIRECTS:
                # follow the redirect before any backoff: the hinted
                # leader is, by the answering node, ready now
                try:
                    client = self._redial(lead)
                except Exception as e:
                    # a failed redial falls through to the typed answer
                    log.debug("redial of %s failed: %r", lead, e)
                    client = None
                if client is not None:
                    self._reconnect(client)
                    return self._submit_once(raw, redirects + 1)
            raise BroadcastUnavailable(
                f"broadcast rejected: {resp.status} {resp.info}",
                info=resp.info, leader_hint=lead)
        raise BroadcastClientError(
            f"broadcast rejected: {resp.status} {resp.info}",
            status=resp.status, info=resp.info)

    def close(self) -> None:
        with self._lock:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
            self._resps.cancel()
            for client in self._owned:
                client.close()
            del self._owned[:]
