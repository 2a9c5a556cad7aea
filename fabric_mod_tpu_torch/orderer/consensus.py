"""The solo consenter: the ordering loop that turns envelopes into blocks.

The port's copy of fabric_mod_tpu/orderer/consensus.py `SoloChain` (:55;
reference: orderer/consensus/solo/consensus.go:183 — the single
goroutine select loop over normal/config messages and the batch timer).

One worker thread drains a submit queue, feeds the block cutter, owns
the batch timer and drives the block writer.  Config envelopes cut the
pending batch and ride alone in their own block, after which the chain
support swaps the channel bundle.  The queue is bounded at the
reference's default cap with blocking puts (its admission gate, which
sheds on a full queue, is not ported).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from fabric_mod_tpu_torch.protos import messages as m

SUBMIT_QUEUE_CAP = 10_000


class ChainHaltedError(Exception):
    pass


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
    reprocess hooks for messages validated under a stale config."""

    def __init__(self, support):
        self._support = support
        self._q: "queue.Queue[Optional[_Msg]]" = queue.Queue(
            maxsize=SUBMIT_QUEUE_CAP)
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
        self._q.put(_Msg(env, False, config_seq))

    def configure(self, env: m.Envelope, config_seq: int) -> None:
        self.wait_ready()
        self._q.put(_Msg(env, True, config_seq))

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
