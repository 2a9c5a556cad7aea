"""The solo consenter: the ordering loop that turns envelopes into blocks.

The port's copy of fabric_mod_tpu/orderer/consensus.py `SoloChain` (:55;
reference: orderer/consensus/solo/consensus.go:183 — the single
goroutine select loop over normal/config messages and the batch timer).

One worker thread drains a submit queue, feeds the block cutter, owns
the batch timer and drives the block writer.  Config envelopes cut the
pending batch and ride alone in their own block, after which the chain
support swaps the channel bundle.  By default the submit queue holds
the reference's 10,000 entries with blocking puts; `queue_cap` > 0 (the
admission setting, orderer/admission.py) bounds it with NON-blocking
puts: a full queue sheds a normal tx with the typed, retryable
ResourceExhaustedError (reason "queue_full"), while config and other
priority envelopes keep a blocking put in halt-aware slices (reference
:66-145).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from fabric_mod_tpu_torch.orderer import admission
from fabric_mod_tpu_torch.protos import messages as m

SUBMIT_QUEUE_CAP = 10_000


class ChainHaltedError(Exception):
    pass


class NotLeaderError(Exception):
    """This consenter cannot take the submission now: it is not the
    leader and knows no live leader to forward it to (an election in
    flight, or a deposed leader stepping down).  `leader_hint` is the
    best-known leader's id, or None (reference: consensus.py:29; the
    reference's Submit redirect carries the same hint)."""

    def __init__(self, msg: str, leader_hint=None):
        super().__init__(msg)
        self.leader_hint = leader_hint


class _Msg:
    __slots__ = ("env", "is_config", "config_seq")

    def __init__(self, env: m.Envelope, is_config: bool, config_seq: int):
        self.env = env
        self.is_config = is_config
        self.config_seq = config_seq


class SoloChain:
    """Single-node consenter (reference: solo/consensus.go:183).

    `support` provides: cutter (BlockCutter), writer (BlockWriter),
    batch_timeout_s(), sequence(), process_config(env, block), and the
    reprocess hooks for messages validated under a stale config.
    `queue_cap` > 0 bounds the submit queue with non-blocking puts."""

    def __init__(self, support, queue_cap: int = 0):
        self._support = support
        self._bounded = queue_cap > 0
        self._q: "queue.Queue[Optional[_Msg]]" = queue.Queue(
            maxsize=queue_cap if self._bounded else SUBMIT_QUEUE_CAP)
        self._halted = threading.Event()
        self._thread = threading.Thread(target=self._run, name="solo-chain",
                                        daemon=True)

    def start(self) -> None:
        self._thread.start()

    def halt(self) -> None:
        if self._halted.is_set():
            return
        self._halted.set()
        try:
            # wake-up only: a blocking put on a full queue would wait on
            # a loop that already exited on _halted
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10)

    def wait_ready(self) -> None:
        """Backpressure point (reference: WaitReady): Queue.put blocks
        while the queue is full."""
        if self._halted.is_set():
            raise ChainHaltedError("chain is halted")

    def order(self, env: m.Envelope, config_seq: int) -> None:
        self.wait_ready()
        self._enqueue(_Msg(env, False, config_seq), is_config=False)

    def configure(self, env: m.Envelope, config_seq: int) -> None:
        self.wait_ready()
        self._enqueue(_Msg(env, True, config_seq), is_config=True)

    def submit_queue_depth(self):
        """(qsize, maxsize): the occupancy the overload gate watches."""
        return self._q.qsize(), self._q.maxsize

    def _enqueue(self, msg: _Msg, is_config: bool) -> None:
        """Bounded: a full queue sheds a normal tx typed instead of
        blocking the submitter; config and priority envelopes (the
        classify parse runs only on the full path) wait for room."""
        if not self._bounded:
            self._q.put(msg)
            return
        if is_config:
            self._put_priority(msg)
            return
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            if admission.is_priority(msg.env):
                self._put_priority(msg)
                return
            raise admission.shed(
                "queue_full", f"submit queue full ({self._q.maxsize})",
                retry_after_s=min(5.0, self._support.batch_timeout_s()),
            ) from None

    def _put_priority(self, msg: _Msg) -> None:
        """A blocking put in slices that re-check the halt: priority
        waits for room, but a halted chain answers typed."""
        while True:
            if self._halted.is_set():
                raise ChainHaltedError("chain is halted")
            try:
                self._q.put(msg, timeout=0.25)
                return
            except queue.Full:
                continue

    def _cut_and_write(self, batch) -> None:
        support = self._support
        support.writer.write_block(support.writer.create_next_block(batch))

    def _run(self) -> None:
        support = self._support
        timer_deadline: Optional[float] = None
        while not self._halted.is_set():
            timeout = None
            if timer_deadline is not None:
                timeout = max(0.0, timer_deadline - time.monotonic())
            try:
                msg = self._q.get(timeout=timeout)
            except queue.Empty:
                # the batch timer fired (reference: case <-timer)
                timer_deadline = None
                batch = support.cutter.cut()
                if batch:
                    self._cut_and_write(batch)
                continue
            if msg is None:
                break
            if msg.is_config:
                # config messages cut the pending batch and ride alone
                if msg.config_seq < support.sequence():
                    try:
                        msg = _Msg(*support.reprocess_config(msg.env))
                    except Exception:
                        continue          # rejected under the new config
                batch = support.cutter.cut()
                if batch:
                    self._cut_and_write(batch)
                    timer_deadline = None
                block = support.writer.create_next_block([msg.env])
                support.process_config(msg.env, block)
                continue
            if msg.config_seq < support.sequence():
                try:
                    support.revalidate_normal(msg.env)
                except Exception:
                    continue              # rejected under the new config
            batches, pending = support.cutter.ordered(msg.env)
            for batch in batches:
                self._cut_and_write(batch)
            if batches:
                timer_deadline = None
            if pending and timer_deadline is None:
                timer_deadline = time.monotonic() + support.batch_timeout_s()
        # a halt drops pending messages, like the reference's Halt
