"""Deliver failover: rotate across orderer endpoints with backoff.

The port's copy of fabric_mod_tpu/peer/blocksprovider.py (reference:
internal/pkg/peer/blocksprovider/blocksprovider.go `DeliverBlocks` —
the retry loop with exponential backoff at :141 — and
internal/pkg/peer/orderers/connection.go's endpoint source).

`FailoverDeliverSource` has the same ``blocks()`` generator contract as
the in-process DeliverService and the single-endpoint
GrpcDeliverSource, so DeliverClient does not depend on the transport.
What it adds:

* a list of orderer endpoints, tried round-robin; a stream that ends
  (disconnect, terminal status) moves to the next endpoint and re-seeks
  from the next block the caller still needs — the caller sees one
  gap-free block sequence;
* backoff between full rotations (every endpoint failed), on the
  Retrier's jittered-exponential schedule, so a fully-down ordering
  service costs sleep, not spin;
* `report_bad_block(n)`: the caller's verify stage (the MCS) flags a
  block that failed verification; the source re-fetches from `n` on a
  different orderer instead of the caller halting commit forever
  (blocksprovider.go:227's VerifyBlock error path).

The fault point ``deliver.failover.stream`` sits on every message of a
stream: an armed rule kills this endpoint's stream mid-flight, and the
source must rotate away.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.comm.grpc_comm import GRPCClient, RpcError
from fabric_mod_tpu_torch.concurrency.locks import RegisteredLock
from fabric_mod_tpu_torch.concurrency.threads import RegisteredThread
from fabric_mod_tpu_torch.observability.logging import get_logger
from fabric_mod_tpu_torch.orderer.server import SERVICE, make_seek_envelope
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils.retry import Retrier

log = get_logger("peer.blocksprovider")


class Endpoint:
    """One orderer address and its TLS material (dialed lazily)."""

    def __init__(self, address: str,
                 server_root_pem: Optional[bytes] = None,
                 client_cert_pem: Optional[bytes] = None,
                 client_key_pem: Optional[bytes] = None,
                 override_authority: Optional[str] = None):
        self.address = address
        self._tls = (server_root_pem, client_cert_pem, client_key_pem,
                     override_authority)
        self._client: Optional[GRPCClient] = None

    def client(self) -> GRPCClient:
        if self._client is None:
            root, cert, key, auth = self._tls
            self._client = GRPCClient(self.address, server_root_pem=root,
                                      client_cert_pem=cert,
                                      client_key_pem=key,
                                      override_authority=auth)
        return self._client

    def reset(self) -> None:
        """Drop the cached channel (a dead connection must not be reused
        after its orderer restarts)."""
        if self._client is not None:
            self._client.close()
            self._client = None


class FailoverDeliverSource:
    """Multi-orderer deliver stream with rotation and backoff."""

    def __init__(self, endpoints: Sequence[Endpoint], channel_id: str,
                 base_backoff_s: float = 0.1, max_backoff_s: float = 10.0,
                 retrier: Optional[Retrier] = None):
        """`retrier` owns the between-full-rotations backoff schedule
        (jittered exponential, utils/retry.py); pass a seeded one for a
        deterministic schedule — the default derives from
        base_backoff_s/max_backoff_s."""
        if not endpoints:
            raise ValueError("at least one orderer endpoint required")
        self._endpoints: List[Endpoint] = list(endpoints)
        self._channel_id = channel_id
        self._retrier = retrier if retrier is not None else Retrier(
            base_s=base_backoff_s, max_s=max_backoff_s,
            name="deliver.failover")
        self._idx = 0                      # current endpoint
        self._resume: Optional[int] = None  # set by report_bad_block
        self._lock = RegisteredLock("peer.blocksprovider._lock")
        self.rotations = 0                 # observability

    def report_bad_block(self, number: int) -> None:
        """The caller's verify stage rejected block `number`: re-fetch
        it from a different orderer (fail-closed per orderer, not
        forever)."""
        with self._lock:
            self._resume = number
        log.warning("block %d failed verification; rotating orderer",
                    number)

    def _rotate(self) -> None:
        with self._lock:
            self._endpoints[self._idx].reset()
            self._idx = (self._idx + 1) % len(self._endpoints)
            self.rotations += 1

    def current_address(self) -> str:
        with self._lock:
            return self._endpoints[self._idx].address

    def close(self) -> None:
        """Close every endpoint's channel."""
        with self._lock:
            for ep in self._endpoints:
                ep.reset()

    def blocks(self, start: int = 0, stop: Optional[int] = None,
               stop_event: Optional[threading.Event] = None,
               timeout_s: float = 30.0) -> Iterator[m.Block]:
        """Yield blocks [start, stop] in order, failing over as needed.

        Ends only when `stop` is reached or `stop_event` fires (an
        endless peer stream passes stop=None and stops by the event).
        `timeout_s` bounds one quiet stream — a source that hangs
        without closing is treated as failed and rotated away from.
        """
        next_needed = start
        consecutive_failures = 0
        while not (stop_event is not None and stop_event.is_set()):
            if stop is not None and next_needed > stop:
                return
            ep = self._endpoints[self._idx]
            made_progress = False
            try:
                seek = make_seek_envelope(self._channel_id, next_needed,
                                          stop)
                stream = ep.client().stream_stream(
                    SERVICE, "Deliver", iter([seek.encode()]),
                    timeout=None)
                watchdog = _StreamWatchdog(stream, timeout_s, stop_event)
                try:
                    for raw in watchdog.iterate():
                        # chaos seam: a mid-stream death of this
                        # endpoint (the except below rotates away)
                        faults.point("deliver.failover.stream")
                        resp = m.DeliverResponse.decode(raw)
                        if resp.block is None:
                            break          # terminal status
                        blk = resp.block
                        if blk.header.number != next_needed:
                            # a gap or a replay: this orderer is not
                            # serving what was asked — rotate
                            log.warning(
                                "orderer %s sent block %d, wanted %d",
                                ep.address, blk.header.number,
                                next_needed)
                            break
                        yield blk
                        # a yield counts as progress only if the
                        # caller's verify stage did not reject it at
                        # once — otherwise N orderers serving one
                        # unverifiable block would rotate in a hot loop
                        with self._lock:
                            if self._resume is not None:
                                next_needed = self._resume
                                self._resume = None
                                break      # rotate below
                            next_needed = blk.header.number + 1
                        made_progress = True
                        consecutive_failures = 0
                        if stop_event is not None and stop_event.is_set():
                            return
                        if stop is not None and next_needed > stop:
                            return
                finally:
                    watchdog.abandon()
                    stream.cancel()
            except RpcError as e:
                log.info("deliver stream to %s failed: %r", ep.address, e)
            except Exception as e:
                # anything else a bad orderer can induce (garbage frames
                # failing DeliverResponse.decode, an armed fault, ...)
                # must rotate, not kill the peer's deliver thread
                log.warning("deliver stream to %s raised: %r",
                            ep.address, e)
            self._rotate()
            if not made_progress:
                consecutive_failures += 1
                if consecutive_failures >= len(self._endpoints):
                    # a full rotation without progress: back off on the
                    # Retrier's schedule (its exponent is clamped, so a
                    # long outage cannot overflow the float)
                    delay = self._retrier.delay_for(
                        consecutive_failures - len(self._endpoints))
                    if stop_event is not None:
                        if stop_event.wait(delay):
                            return
                    else:
                        time.sleep(delay)


class _StreamWatchdog:
    """Bounds the gap between stream messages: a stream that stalls
    longer than `timeout_s` without closing is abandoned (cancelled) so
    the caller can rotate — TCP keepalive only detects a dead
    connection, not a live but silent orderer."""

    _DONE = object()
    _POLL_S = 0.5                         # stop_event responsiveness

    def __init__(self, stream, timeout_s: float,
                 stop_event: Optional[threading.Event]):
        self._stream = stream
        self._timeout = timeout_s
        self._stop_event = stop_event
        self._abandoned = threading.Event()

    def abandon(self) -> None:
        """Unblock the pump thread (it must never stay parked in q.put
        after the consumer walks away — that would leak one thread per
        rotation)."""
        self._abandoned.set()

    def iterate(self):
        q: "queue.Queue" = queue.Queue(8)

        def pump():
            try:
                for item in self._stream:
                    while not self._abandoned.is_set():
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._abandoned.is_set():
                        return
            except Exception as e:
                log.debug("watchdog pump exiting: %r", e)
            while not self._abandoned.is_set():
                try:
                    q.put(self._DONE, timeout=0.5)
                    return
                except queue.Full:
                    continue

        t = RegisteredThread(target=pump, name="deliver-pump",
                             structure="peer.blocksprovider")
        t.start()
        try:
            waited = 0.0
            while True:
                # short polls so a stop_event (peer shutdown) is seen
                # within _POLL_S even under a long idle timeout
                try:
                    item = q.get(timeout=min(self._POLL_S,
                                             self._timeout))
                except queue.Empty:
                    if (self._stop_event is not None
                            and self._stop_event.is_set()):
                        self._stream.cancel()
                        return
                    waited += self._POLL_S
                    if waited >= self._timeout:
                        self._stream.cancel()  # a silent stream
                        return
                    continue
                if item is self._DONE:
                    return
                waited = 0.0
                yield item
                if (self._stop_event is not None
                        and self._stop_event.is_set()):
                    self._stream.cancel()
                    return
        finally:
            self.abandon()
