"""Pipelined block-commit engine: overlap stage(N+1) with finish+commit(N).

The port's copy of fabric_mod_tpu/peer/commitpipe.py
`PipelinedCommitter` (:138) and `ValidatorCommitTarget` (:117)
(reference: the serial StoreBlock composition of
gossip/state/state.go:817 — validate -> MVCC -> commit — pipelined the
way FastFabric and StreamChain pipeline Fabric's commit path).

The validator splits a block into `stage` (host unpack, policy staging
and the verify DISPATCH, no wait) and `finish` (await the verdicts,
resolve the flags in order) — peer/txvalidator.py.  This module runs
that seam as a bounded pipeline over an in-order block stream:

  caller       submit(block)   -> bounded in-queue (backpressure)
  stage loop   stage(N+1): host unpack + device dispatch, CONCURRENT
               with ...
  commit loop  finish(N): await verdicts, resolve flags; then
               ledger.commit_block(N): MVCC + block store + state

`depth` bounds how many blocks may be staged but not yet committed;
depth 1 gives the synchronous Committer's results bit for bit.  A
staged block that sets `StagedBlock.needs_barrier` (config txs,
VALIDATION_PARAMETER writes, lifecycle writes: state that staging
reads) makes the stage loop wait for that block's commit before it
stages the next one.

On a card, stage enqueues the verify on the thread of the stage loop
and the commit loop consumes its device mask: every launch of both is
on the device's default stream, which orders them.

A failure is sticky: the first error is kept, later submits and waits
raise it, and both loops drain; the owner discards such a pipe and
builds a new one from the committed height (peer/channel.py).

With the tracer armed (observability/tracing.py) each block gets one
timeline, labelled by `consumer`: the stage loop starts it around the
staging, the StagedBlock carries it, and the commit loop resumes it
around the verdict wait and the commit, then finishes it (reference
:420-473).

Metrics and health are the reference's (:68-107, :210-225, :366): the
`fabric_commitpipe_*` stage, await and commit histograms, the
per-consumer occupancy gauge and the barrier and block counters on the
port's default metrics provider, beside the cumulative `stage_secs`,
`await_secs` and `commit_secs`; each pipe registers a checker in
observability/opsserver.default_health() under a per-instance key
(`commitpipe[<consumer>#<n>]`: consumer labels repeat, and one pipe's
entry must not mask another's) that fails while the pipe holds a
sticky error and is not closed, and `close()` unregisters it, so a
poisoned pipe flips /healthz until its owner discards it.  The
reference's fault points are at the same places: `commitpipe.stage`
before a block stages and `commitpipe.commit` between the stage and the
verdict wait; either poisons the pipe like a real failure.
"""
from __future__ import annotations

import functools
import itertools
import logging
import queue
import threading
import time
from typing import Callable, List, Optional

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.ledger.kvledger import LedgerError
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)
from fabric_mod_tpu_torch.observability.opsserver import default_health
from fabric_mod_tpu_torch.protos import protoutil

log = logging.getLogger(__name__)

_STAGE_OPTS = MetricOpts(
    "fabric", "commitpipe", "stage_seconds",
    help="Host unpack + policy compilation + device dispatch time per "
         "block (the pipeline's front stage).")
_AWAIT_OPTS = MetricOpts(
    "fabric", "commitpipe", "await_seconds",
    help="Device-verdict wait per block (overlapped with the next "
         "block's staging when depth > 1).")
_COMMIT_OPTS = MetricOpts(
    "fabric", "commitpipe", "commit_seconds",
    help="Flag resolution + MVCC + ledger commit time per block.")
_OCCUPANCY_OPTS = MetricOpts(
    "fabric", "commitpipe", "occupancy",
    help="Blocks staged but not yet committed (pipeline fill; bounded "
         "by the configured depth).  Labeled per consumer: multiple "
         "live engines (a deliver client's private pipe + a channel's "
         "shared one) must not overwrite each other's fill level.",
    label_names=("consumer",))
_BARRIER_OPTS = MetricOpts(
    "fabric", "commitpipe", "barriers_total",
    help="Barrier drains: blocks whose config/VALIDATION_PARAMETER/"
         "lifecycle writes forced the next stage to wait for commit.")
_BLOCKS_OPTS = MetricOpts(
    "fabric", "commitpipe", "blocks_total",
    help="Blocks committed through a pipelined committer.")


@functools.lru_cache(maxsize=None)
def _metrics():
    prov = default_provider()
    return (prov.histogram(_STAGE_OPTS),
            prov.histogram(_AWAIT_OPTS),
            prov.histogram(_COMMIT_OPTS),
            prov.gauge(_OCCUPANCY_OPTS),
            prov.counter(_BARRIER_OPTS),
            prov.counter(_BLOCKS_OPTS))


# the per-instance suffix of a pipe's health-registry key
_pipe_seq = itertools.count()


class ValidatorCommitTarget:
    """The minimal channel-shaped commit target: one TxValidator bound
    to one ledger (peer.Channel provides the same three names)."""

    def __init__(self, validator, ledger):
        self.validator = validator
        self.ledger = ledger

    def stage_block(self, block):
        return self.validator.stage(block)

    def commit_staged(self, staged) -> List[int]:
        flags = staged.validator.finish(staged)
        return self.ledger.commit_block(staged.block, flags, staged.rwsets)


class PipelinedCommitter:
    """Bounded commit pipeline over an in-order block stream.

    `submit(block)` enqueues for staging; blocks commit strictly in
    submission order on the commit loop.  `store_block` is the
    synchronous facade: submit, then wait for that block's commit and
    return its flags.  The two worker threads start on the first
    submit; `close()` drains and joins them."""

    def __init__(self, channel, depth: int = 2, in_queue: int = 8,
                 on_commit: Optional[Callable] = None,
                 on_error: Optional[Callable] = None,
                 consumer: str = "adhoc"):
        """`channel`: stage_block/commit_staged/.ledger (peer.Channel
        or ValidatorCommitTarget).  `depth`: max staged-but-uncommitted
        blocks (floor 1).  `on_commit(block, flags)` fires on the commit
        loop after each commit, in block order; what it raises fails
        the pipe like a failed commit (the reference logs it).
        `on_error(exc)` fires once on the first failure.  `consumer`
        labels the blocks' tracing timelines ("deliver", "channel",
        "shard<i>")."""
        self._channel = channel
        self._consumer = consumer
        self.depth = max(1, depth)
        self._in_q: "queue.Queue" = queue.Queue(max(1, in_queue))
        self._staged_q: "queue.Queue" = queue.Queue()
        self._on_commit = on_commit
        self._on_error = on_error
        # one condition guards the pipeline state: the inflight count
        # (the depth bound), the committed height (barrier and flush
        # waits) and the sticky first error
        self._cv = threading.Condition()
        self._inflight = 0
        self._height = channel.ledger.height
        self._barrier_height: Optional[int] = None
        self._last_submitted: Optional[int] = None
        self._err: Optional[Exception] = None
        self._closed = False
        self._started = False
        # serializes producers through the in-queue put, so two
        # overlapping submitters cannot enqueue out of order
        self._submit_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        # cumulative wall seconds per stage: the stage loop writes
        # stage_secs, the commit loop await_secs and commit_secs
        self.stage_secs = 0.0
        self.await_secs = 0.0
        self.commit_secs = 0.0
        (self._m_stage, self._m_await, self._m_commit, occupancy,
         self._m_barriers, self._m_blocks) = _metrics()
        self._m_occupancy = occupancy.with_labels(consumer)
        self._health_key = f"commitpipe[{consumer}#{next(_pipe_seq)}]"
        default_health().register(self._health_key, self._health_check)

    def _health_check(self) -> None:
        if self._err is not None and not self._closed:
            raise RuntimeError(
                f"commit pipeline [{self._consumer}] poisoned: "
                f"{self._err!r}")

    @property
    def error(self) -> Optional[Exception]:
        return self._err

    @property
    def closed(self) -> bool:
        return self._closed

    def _ensure_started(self) -> None:
        if self._started:
            return
        self._started = True
        for name, fn in (("commitpipe-stage", self._stage_loop),
                         ("commitpipe-commit", self._commit_loop)):
            t = RegisteredThread(target=fn, name=name,
                                 structure="PipelinedCommitter")
            t.start()
            self._threads.append(t)

    def _fail(self, e: Exception) -> None:
        with self._cv:
            if self._err is None:
                self._err = e
            self._cv.notify_all()
        if self._on_error is not None:
            try:
                self._on_error(e)
            except Exception:
                log.exception("on_error callback raised")

    # -- producer side ---------------------------------------------------
    def submit(self, block) -> None:
        """Enqueue one block.  Blocks only on the bounded in-queue.  A
        block out of number order is rejected here, to its own caller,
        with the ledger's error type, before it can poison the pipe."""
        with self._submit_lock:
            with self._cv:
                if self._err is not None:
                    raise self._err
                if self._closed:
                    raise RuntimeError("commit pipeline is closed")
                num = block.header.number
                # the chain may have advanced past this pipe's
                # construction height (another committer before it)
                base = max(self._height, self._channel.ledger.height)
                expected = (base if self._last_submitted is None
                            else max(base, self._last_submitted + 1))
                if num != expected:
                    raise LedgerError(
                        f"submit out of order: block {num}, pipeline "
                        f"expects {expected}")
                self._last_submitted = num
            self._ensure_started()
            self._in_q.put(block)

    def store_block(self, block) -> List[int]:
        """Submit and wait for THIS block's commit; its final flags."""
        num = block.header.number
        self.submit(block)
        self.wait_height(num + 1)
        return list(protoutil.block_txflags(block))

    def wait_height(self, height: int,
                    timeout_s: Optional[float] = None) -> bool:
        """Wait until `height` blocks are committed (False on timeout);
        re-raises the pipeline's error if it failed first."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        with self._cv:
            while self._height < height and self._err is None:
                left = None if deadline is None else \
                    deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(timeout=left if left is not None else 0.5)
            if self._height >= height:
                # the waiter's own block is committed, even if a later
                # block's failure set the sticky error meanwhile
                return True
            raise self._err

    def flush(self, timeout_s: Optional[float] = None) -> bool:
        """Wait until every submitted block is committed."""
        with self._cv:
            last = self._last_submitted
        if last is None:
            if self._err is not None:
                raise self._err
            return True
        return self.wait_height(last + 1, timeout_s)

    def close(self, timeout_s: Optional[float] = None) -> None:
        """Drain submitted work and join the workers (None: until
        drained — close never returns with commits in flight).  A
        pending error stays readable on `.error`."""
        with self._submit_lock:
            with self._cv:
                if self._closed:
                    return
                self._closed = True
            started = self._started
        # a closed pipe leaves the health registry: its error reached its
        # callers, and the entry would pin the pipe and its channel
        default_health().unregister(self._health_key)
        if not started:
            return
        self._in_q.put(None)
        me = threading.current_thread()
        for t in self._threads:
            # an on_error callback may close from a worker
            if t is not me:
                t.join(timeout_s)

    # -- stage loop: host unpack + device dispatch -----------------------
    def _stage_loop(self) -> None:
        try:
            while True:
                block = self._in_q.get()
                if block is None:
                    return
                with self._cv:
                    # stage only when a slot is free AND no barrier
                    # block is still committing
                    while self._err is None and (
                            self._inflight >= self.depth
                            or (self._barrier_height is not None
                                and self._height < self._barrier_height)):
                        self._cv.wait(timeout=0.5)
                    if self._err is not None:
                        continue           # drain mode
                    self._inflight += 1
                    self._m_occupancy.set(self._inflight)
                t0 = time.perf_counter()
                # chaos seam: an engine crash while staging (the sticky
                # error below is the recovery contract under test)
                faults.point("commitpipe.stage")
                # one timeline a block; the stage side's sub-spans land
                # here, and the staged block carries it to the commit
                # loop (None disarmed: no object, no write)
                tl = tracing.start_timeline(self._consumer,
                                            block.header.number)
                with tracing.timeline_scope(tl):
                    staged = self._channel.stage_block(block)
                if tl is not None:
                    staged.trace_timeline = tl
                dt = time.perf_counter() - t0
                self.stage_secs += dt
                self._m_stage.observe(dt)
                if staged.needs_barrier:
                    self._m_barriers.add()
                    with self._cv:
                        self._barrier_height = block.header.number + 1
                self._staged_q.put(staged)
        except Exception as e:
            self._fail(e)
            # keep draining so a bounded-queue producer never deadlocks
            while self._in_q.get() is not None:
                pass
        finally:
            self._staged_q.put(None)

    # -- commit loop: await verdicts, resolve, MVCC + commit -------------
    def _commit_loop(self) -> None:
        while True:
            staged = self._staged_q.get()
            if staged is None:
                return
            tl = getattr(staged, "trace_timeline", None)
            try:
                # chaos seam: a crash between the stage and the
                # verdict wait — nothing of the block reached the ledger
                faults.point("commitpipe.commit")
                with tracing.timeline_scope(tl):
                    t0 = time.perf_counter()
                    staged.resolve_mask()  # the device-verdict wait
                    t1 = time.perf_counter()
                    flags = self._channel.commit_staged(staged)
                    t2 = time.perf_counter()
            except Exception as e:
                self._drain_failed(e)
                return
            finally:
                tracing.finish_timeline(tl)
            self.await_secs += t1 - t0
            self.commit_secs += t2 - t1
            self._m_await.observe(t1 - t0)
            self._m_commit.observe(t2 - t1)
            self._m_blocks.add()
            with self._cv:
                self._inflight -= 1
                self._m_occupancy.set(self._inflight)
                self._height = staged.block.header.number + 1
                self._cv.notify_all()
            if self._on_commit is not None:
                try:
                    self._on_commit(staged.block, flags)
                except Exception as e:
                    self._drain_failed(e)
                    return

    def _drain_failed(self, e: Exception) -> None:
        """The commit loop's failure: keep it, then drain the staged
        queue so the stage loop never blocks on it."""
        self._fail(e)
        while self._staged_q.get() is not None:
            pass
