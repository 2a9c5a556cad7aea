"""Gossip state transfer: the in-order payload buffer feeding the commit
path, with anti-entropy catch-up.

The port's copy of fabric_mod_tpu/gossip/state.py (reference:
gossip/state/state.go — the payloads buffer and the deliverPayloads
loop at :583 popping blocks in sequence and committing at :817;
anti-entropy requests for missing ranges at :583-838).

The background drain loop is event-driven: `add_block` signals the
buffer's condition whenever the next in-order block becomes poppable,
so commit latency is wakeup latency, not a poll interval.  The
anti-entropy tick keeps its own interval.  Drained blocks go to the
channel's shared PipelinedCommitter when the channel has one
(`Channel(pipeline_depth>0)`), and to `store_block` otherwise.

The loop must outlive a failed commit, as the reference's does: the
drain rewinds the buffer so the block stays requestable.  Where the
reference logs the failure, this provider keeps it in `errors` (a
commit pipe that failed on its own thread included), so that a caller
can fail on it: nothing here turns a verifier's error into a dropped
block.  A popped block that the channel already holds (committed by
this peer's own deliver client) is skipped; the reference hands it to
the ledger, which refuses it as out of order.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, List, Optional

from fabric_mod_tpu_torch.concurrency import RegisteredLock, RegisteredThread
from fabric_mod_tpu_torch.ledger.kvledger import LedgerError
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.protos import messages as m


class PayloadsBuffer:
    """Min-heap of blocks keyed by number; pop only when the next
    expected sequence is present (reference: the payloads buffer)."""

    def __init__(self, next_seq: int):
        self._heap: List = []
        self._have: set = set()
        self.next_seq = next_seq
        self._known_to = next_seq          # 1 past the highest num seen
        self._lock = RegisteredLock("gossip-payloads")
        self.ready = threading.Condition(self._lock)

    def push(self, block: m.Block) -> bool:
        num = block.header.number
        with self._lock:
            if num >= self._known_to:
                self._known_to = num + 1
            if num < self.next_seq or num in self._have:
                return False               # stale/duplicate
            heapq.heappush(self._heap, (num, block.encode()))
            self._have.add(num)
            if num == self.next_seq:
                self.ready.notify_all()
            return True

    def pop_in_order(self) -> Optional[m.Block]:
        with self._lock:
            if self._heap and self._heap[0][0] == self.next_seq:
                num, raw = heapq.heappop(self._heap)
                self._have.discard(num)
                self.next_seq += 1
                return m.Block.decode(raw)
            return None

    def wait_ready(self, timeout_s: Optional[float]) -> bool:
        """Block until the next in-order block is poppable (True) or the
        timeout lapses (False); `wake()` also returns the waiter."""
        with self._lock:
            if self._heap and self._heap[0][0] == self.next_seq:
                return True
            return self.ready.wait(timeout=timeout_s)

    def wake(self) -> None:
        """Wake any wait_ready waiter (shutdown, external prod)."""
        with self._lock:
            self.ready.notify_all()

    def resync(self, next_seq: int) -> None:
        """Rewind the expected sequence (lowering only): a popped block
        that never committed is gone from the heap, and without the
        rewind every redelivery would be rejected as stale and the gap
        would be invisible to anti-entropy.  Buffered future blocks stay
        valid."""
        with self._lock:
            if next_seq < self.next_seq:
                self.next_seq = next_seq

    def missing_range(self) -> Optional[range]:
        """The gap blocking progress, if any (for anti-entropy).  An
        empty heap still reports a gap when a block known to exist (it
        was pushed, popped into a committer that failed, then resynced)
        is missing."""
        with self._lock:
            head = self._heap[0][0] if self._heap else self._known_to
            if head <= self.next_seq:
                return None
            return range(self.next_seq, head)


class GossipStateProvider:
    """Binds the buffer to a channel; blocks commit strictly in order
    (reference: state.go:583)."""

    def __init__(self, channel, request_missing: Optional[Callable] = None,
                 on_tick: Optional[Callable] = None):
        """`on_tick` runs on the anti-entropy cadence beside the gap
        check (the node wires its pull engine here): a block lost at the
        chain's tail leaves the buffer gapless, and only a periodic
        pull can find it."""
        self._channel = channel
        self.buffer = PayloadsBuffer(channel.ledger.height)
        self._request_missing = request_missing
        self._on_tick = on_tick
        self._tick_seq = -1                # buffer progress marker
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # serializes pop->commit sequences: two concurrent drains
        # interleaving pops would submit blocks out of order
        self._drain_lock = RegisteredLock("gossip-state-drain")
        self._active_pipe = None           # the pipe drain last fed
        # what the background loop and stop() caught, in order
        self.errors: List[BaseException] = []
        self.stale = 0                     # popped blocks already held

    def _keep(self, e: BaseException) -> None:
        if not any(e is seen for seen in self.errors):
            self.errors.append(e)

    def add_block(self, block: m.Block) -> bool:
        """A verified block in (the node's MCS check comes first).
        Pushing the next in-order block wakes the drain loop."""
        return self.buffer.push(block)

    def _commit_pipeline(self):
        """The channel's shared PipelinedCommitter, when it has one."""
        getter = getattr(self._channel, "commit_pipeline", None)
        return getter() if getter is not None else None

    def _refresh_pipe(self):
        """Fetch the channel's pipe; on a NEW pipe (first use, or the
        channel rebuilt a failed one) rewind the buffer to the committed
        height: blocks handed to the old pipe but never committed are
        not coming back.  The old pipe's failure is kept.  Caller holds
        _drain_lock."""
        pipe = self._commit_pipeline()
        if pipe is not self._active_pipe:
            old = self._active_pipe
            if old is not None and old.error is not None:
                self._keep(old.error)
            self.buffer.resync(self._channel.ledger.height)
            self._active_pipe = pipe
        return pipe

    def drain(self, max_blocks: int = 1000) -> int:
        """Commit everything poppable now; returns the count handed to
        the commit path.  With a commit pipe the blocks are SUBMITTED in
        order and commit asynchronously: `flush()` (or `stop()`) waits
        for them."""
        n = 0
        ledger = self._channel.ledger
        with self._drain_lock:
            pipe = self._refresh_pipe()
            with tracing.span("gossip.drain") as drain_span:
                while n < max_blocks:
                    block = self.buffer.pop_in_order()
                    if block is None:
                        break
                    if block.header.number < ledger.height:
                        self.stale += 1
                        continue
                    try:
                        if pipe is not None:
                            pipe.submit(block)
                        else:
                            self._channel.store_block(block)
                    except LedgerError:
                        if block.header.number < ledger.height:
                            # the deliver client committed it meanwhile
                            self.stale += 1
                            continue
                        self.buffer.resync(ledger.height)
                        raise
                    except Exception:
                        # the popped block never committed: rewind so it
                        # stays requestable
                        self.buffer.resync(ledger.height)
                        raise
                    n += 1
                drain_span.set(blocks=n)
        return n

    def flush(self, timeout_s: Optional[float] = None) -> bool:
        """Wait until every drained block is committed (a no-op on the
        synchronous path); raises the failure of the pipe they went to
        (the reference waits on the channel's current pipe, which the
        channel may already have replaced)."""
        with self._drain_lock:
            pipe = self._active_pipe
        if pipe is None:
            return True
        return pipe.flush(timeout_s)

    def request_gap(self) -> Optional[range]:
        """Request the gap blocking progress now, if any (a receiver
        that saw a block beyond its next needed one knows the gap
        exists; the periodic tick is the backstop)."""
        gap = self.buffer.missing_range()
        if gap is not None and self._request_missing is not None:
            self._request_missing(gap)
        return gap

    def anti_entropy_tick(self) -> Optional[range]:
        """If a gap blocks progress, ask for it (reference: the
        anti-entropy goroutine).  Also picks up a pipe that failed on a
        quiescent channel, so the lost tail becomes requestable.  The
        pull hook runs only on a quiescent channel (no buffer progress
        since the previous tick)."""
        with self._drain_lock:
            self._refresh_pipe()
        gap = self.request_gap()
        seq = self.buffer.next_seq
        if self._on_tick is not None and seq == self._tick_seq:
            self._on_tick()
        self._tick_seq = seq
        return gap

    # -- background mode --------------------------------------------------
    def start(self, interval_s: float = 0.5) -> None:
        """Idempotent: a second start() does not spawn a second loop.
        `interval_s` is the anti-entropy cadence only; commits are
        driven by `add_block`."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop():
            next_tick = time.monotonic() + interval_s
            while not self._stop.is_set():
                timeout = max(0.0, next_tick - time.monotonic())
                got = self.buffer.wait_ready(timeout)
                if self._stop.is_set():
                    return
                if got:
                    try:
                        self.drain()
                    except Exception as e:     # kept; the loop survives
                        self._keep(e)
                if time.monotonic() >= next_tick:
                    try:
                        self.anti_entropy_tick()
                    except Exception as e:     # kept; the loop survives
                        self._keep(e)
                    next_tick = time.monotonic() + interval_s
        self._thread = RegisteredThread(target=loop,
                                        name="gossip-state-drain",
                                        structure="GossipStateProvider")
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop, drain, and wait out pending commits (up to 600
        s).  Never raises: a failure is kept in `errors`."""
        self._stop.set()
        self.buffer.wake()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                self._keep(RuntimeError("the drain loop did not stop"))
        try:
            self.drain()
            if not self.flush(timeout_s=600.0):
                self._keep(TimeoutError("the commit pipe did not drain "
                                        "within 600 s"))
        except Exception as e:
            self._keep(e)
