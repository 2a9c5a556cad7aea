"""Staged broadcast ingress: coalesce concurrent submitters' Writers checks.

The port's copy of fabric_mod_tpu/orderer/stagedbroadcast.py (:54-190).
Unstaged, each `Broadcast.submit` runs its own Writers-policy check.
Staged, concurrent submitters deposit their normal-tx envelopes into a
per-channel lane and block on a verdict slot; one drainer thread per
lane takes everything waiting (up to `max_batch`), runs the cohort
through `StandardChannelProcessor.process_normal_msgs` — one bundle
read, ONE `verify_many` call — and hands each submitter its own typed
verdict.  Each submitter then goes on, on its own thread, to
`chain.order`.  A lane coalesces only submitters that are blocked at
the same time, so a cohort is at most as large as the number of
submitter threads; one thread gives cohorts of one.

Config txs never enter a lane: they keep the blocking path.

If the cohort's call raises, the lane judges each envelope alone
(`process_normal_msg`) through the same processor, and so through the
same `verify_many` seam: a fault costs amortisation, never a lost
submission, and a device error surfaces as its envelope's exception.
`close()` leaves no submitter blocked: a deposit that races the close
is refused with a typed error.  A cohort's call is the
"broadcast.stage" span (tracer armed); the reference's
`orderer.broadcast.stage` fault point fails a drain's cohort call, which
takes the same per-envelope path.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.observability import tracing


class IngressClosedError(RuntimeError):
    """The staged ingress closed before this submission was judged."""


class _Pending:
    """One deposited submission: its envelope, its processor and the
    verdict slot its submitter blocks on."""

    __slots__ = ("env", "processor", "_done", "_seq", "_err")

    def __init__(self, env, processor):
        self.env = env
        self.processor = processor
        self._done = threading.Event()
        self._seq = None                 # config sequence on acceptance
        self._err = None                 # typed exception on rejection

    def resolve(self, verdict) -> None:
        if isinstance(verdict, BaseException):
            self._err = verdict
        else:
            self._seq = verdict
        self._done.set()

    def wait(self) -> int:
        self._done.wait()
        if self._err is not None:
            raise self._err
        return self._seq


class _Lane:
    """One channel's lane: a bounded deposit queue and its drainer."""

    def __init__(self, channel_id: str, max_batch: int):
        self._max = max(1, max_batch)
        self._q: "queue.Queue" = queue.Queue(max(64, 2 * self._max))
        # orders deposits against close: a deposit lands before the
        # close's sentinel, or is refused
        self._mu = threading.Lock()
        self._closed = False
        self._thread = RegisteredThread(
            target=self._run, name=f"broadcast-stage-{channel_id}",
            structure="stagedbroadcast")
        self._thread.start()

    def deposit(self, pending: _Pending) -> None:
        with self._mu:
            if self._closed:
                pending.resolve(IngressClosedError("staged ingress closed"))
                return
            self._q.put(pending)         # bounded: deposits backpressure

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join(timeout=60)
        # only a drainer that died or outlived its join leaves work here
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if p is not None:
                p.resolve(IngressClosedError("staged ingress closed"))
        if self._thread.is_alive():
            raise RuntimeError("staged ingress drainer did not stop")

    def _run(self) -> None:
        closing = False
        while not closing:
            head = self._q.get()
            closing = head is None
            batch: List[_Pending] = [] if closing else [head]
            while len(batch) < self._max:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    closing = True
                    continue
                batch.append(nxt)
            if batch:
                self._flush(batch)

    @staticmethod
    def _flush(batch: List[_Pending]) -> None:
        try:
            with tracing.span("broadcast.stage", items=len(batch)):
                if faults.point("orderer.broadcast.stage"):
                    raise RuntimeError("injected stage fault")
                verdicts = batch[0].processor.process_normal_msgs(
                    [p.env for p in batch])
        except Exception:                # the cohort's call failed: judge
            for p in batch:              # each envelope alone, same seam
                try:
                    p.resolve(p.processor.process_normal_msg(p.env))
                except Exception as e:   # the slot's verdict
                    p.resolve(e)
            return
        for p, v in zip(batch, verdicts):
            p.resolve(v)


class StagedIngress:
    """The per-channel lanes behind `Broadcast.submit`."""

    def __init__(self, max_batch: int):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._max = max_batch
        self._mu = threading.Lock()
        self._lanes: Dict[str, _Lane] = {}
        self._closed = False

    def submit(self, channel_id: str, processor, env) -> int:
        """Deposit one normal tx and block until its verdict: the config
        sequence it was validated under, or the typed rejection."""
        pending = _Pending(env, processor)
        self._lane(channel_id).deposit(pending)
        return pending.wait()

    def _lane(self, channel_id: str) -> _Lane:
        with self._mu:
            if self._closed:
                raise IngressClosedError("staged ingress closed")
            lane = self._lanes.get(channel_id)
            if lane is None:
                lane = _Lane(channel_id, self._max)
                self._lanes[channel_id] = lane
            return lane

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            lanes = list(self._lanes.values())
            self._lanes.clear()
        for lane in lanes:
            lane.close()
