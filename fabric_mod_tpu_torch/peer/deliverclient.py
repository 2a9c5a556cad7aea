"""Peer deliver client: pull ordered blocks, verify, commit — pipelined.

The port's copy of fabric_mod_tpu/peer/deliverclient.py `DeliverClient`
(:64; reference: internal/pkg/peer/blocksprovider/blocksprovider.go
`DeliverBlocks` — the pull loop with `VerifyBlock` at :227 — feeding
the commit loop of gossip/state/state.go:583).

Three stages, the double buffer:

  stage 1 (the caller of `run`):  pull block N+2, hash-check + verify
                                  its orderer signature (the MCS)
  stage 2 (pipeline stage loop):  host unpack + policy staging of
                                  block N+1, then DISPATCH its device
                                  verify without waiting for it
  stage 3 (pipeline commit loop): await block N's verdicts, resolve
                                  flags, MVCC + commit

Stages 2 and 3 are peer/commitpipe.PipelinedCommitter at depth 2,
always, as in the reference; this client owns stage 1 and the MCS gate.
Commit order is block-number order by construction (one puller).  A
block that fails the MCS is dropped and recorded in `rejected`; it ends
the pull, unless the source can fetch it again from another orderer
(`report_bad_block`, peer/blocksprovider.py).  `on_commit(block)` fires after each commit (the gossip
service pushes the leader's blocks to the other peers from it); what it
raises fails the pipe and is re-raised by `run()`, where the reference
logs it as advisory.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from fabric_mod_tpu_torch.concurrency import OwnedState
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
from fabric_mod_tpu_torch.peer.mcs import BlockVerificationError
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

PIPELINE_DEPTH = 2
# blocks verified by the MCS and waiting to be staged
IN_QUEUE = 8


class DeliverDisconnected(Exception):
    """The deliver stream died mid-pull.  `height` is the committed
    ledger height, the block a fresh client resumes from."""

    def __init__(self, msg: str, height: Optional[int] = None):
        super().__init__(msg)
        self.height = height


class DeliverClient:
    """Pulls blocks from a deliver source into a channel's commit path.

    `source` provides `blocks(start, stop_event=None, timeout_s=...)`
    (orderer/deliver.DeliverService)."""

    def __init__(self, channel: Channel, source,
                 on_commit: Optional[Callable[[m.Block], None]] = None):
        self._channel = channel
        self._source = source
        self._on_commit = on_commit
        self._stop = threading.Event()
        # stage/await/commit seconds of pipes already closed (run()
        # builds a fresh engine per invocation: the client is reusable)
        self._secs_base = [0.0, 0.0, 0.0]
        self._pipe = self._make_pipe()
        self.rejected: List[int] = []      # block numbers that failed MCS
        self.mcs_secs = 0.0                # stage 1's block verification
        # stage 1's exclusivity: run() claims this state for its thread;
        # a second concurrent run() on one client would pull and submit
        # twice, and armed, its claim raises (sequential re-runs
        # re-claim freely)
        self._runner = OwnedState("deliverclient-runner")

    def _make_pipe(self) -> PipelinedCommitter:
        # a dead pipeline stops the pull at once (the source honours
        # the stop event)
        return PipelinedCommitter(
            self._channel, depth=PIPELINE_DEPTH, in_queue=IN_QUEUE,
            on_commit=self._handle_commit if self._on_commit else None,
            on_error=lambda _e: self._stop.set(), consumer="deliver")

    def _handle_commit(self, block: m.Block, _flags) -> None:
        self._on_commit(block)

    # cumulative wall seconds per stage; commit_secs is everything after
    # the dispatch: verdict await + resolve + MVCC + ledger commit
    @property
    def stage_secs(self) -> float:
        return self._secs_base[0] + self._pipe.stage_secs

    @property
    def await_secs(self) -> float:
        return self._secs_base[1] + self._pipe.await_secs

    @property
    def commit_secs(self) -> float:
        return (self._secs_base[1] + self._secs_base[2]
                + self._pipe.await_secs + self._pipe.commit_secs)

    # -- stage 1: pull + verify ------------------------------------------
    def run(self, idle_timeout_s: float = 30.0) -> None:
        """Pull from the ledger's current height until `stop()` or the
        source goes idle for `idle_timeout_s`.  Blocking; one run() at
        a time: armed, a concurrent second run() raises RaceError.
        Re-raises the pipeline's error, and a dropped stream as
        DeliverDisconnected."""
        self._runner.claim()
        try:
            self._run_claimed(idle_timeout_s)
        finally:
            # released on every exit, or each later run() would be a
            # false race
            self._runner.release()

    def _run_claimed(self, idle_timeout_s: float) -> None:
        if self._pipe.closed:
            self._secs_base[0] += self._pipe.stage_secs
            self._secs_base[1] += self._pipe.await_secs
            self._secs_base[2] += self._pipe.commit_secs
            self._pipe = self._make_pipe()
            self._stop.clear()
        start = self._channel.ledger.height
        prev_hash = None
        if start > 0:
            prev = self._channel.ledger.get_block_by_number(start - 1)
            # a ledger bootstrapped from a snapshot holds no block below
            # its base: its block store's base marker carries the hash
            prev_hash = (protoutil.block_header_hash(prev.header)
                         if prev is not None else
                         self._channel.ledger.blockstore.last_block_hash)
        dropped: Optional[Exception] = None
        try:
            source_iter = iter(self._source.blocks(
                start, stop_event=self._stop, timeout_s=idle_timeout_s))
            while True:
                # "recv" attributes stage 1: the pull wait, the MCS
                # hash and signature check and the hand-off, a block
                # (reference :187)
                with tracing.span("recv") as recv_span:
                    try:
                        block = next(source_iter)
                    except StopIteration:
                        break              # clean end / idle timeout
                    except Exception as e:
                        dropped = e        # raised after the drain below
                        break
                    if self._stop.is_set():
                        break
                    recv_span.set(block=block.header.number)
                    t0 = time.perf_counter()
                    try:
                        self._channel.mcs.verify_block(
                            self._channel.channel_id, block,
                            expected_prev_hash=prev_hash)
                    except BlockVerificationError:
                        # a tampered or mis-signed block is never
                        # committed.  A failover source is asked to
                        # fetch it again from a different orderer
                        # (reference: blocksprovider.go:227 — disconnect
                        # and retry another orderer); a single-endpoint
                        # source fails closed by stopping
                        self.rejected.append(block.header.number)
                        del self.rejected[:-1000]  # bounded memory
                        report = getattr(self._source,
                                         "report_bad_block", None)
                        if report is not None:
                            report(block.header.number)
                            continue
                        break
                    finally:
                        self.mcs_secs += time.perf_counter() - t0
                    prev_hash = protoutil.block_header_hash(block.header)
                    try:
                        self._pipe.submit(block)
                    except Exception:
                        if self._pipe.error is None:
                            raise          # not a pipeline failure
                        break              # re-raised after close below
        finally:
            # run() never returns with commits in flight
            self._pipe.close()
        if dropped is not None:
            height = self._channel.ledger.height
            raise DeliverDisconnected(
                f"deliver stream dropped at height {height}: "
                f"{dropped!r}", height=height) from dropped
        if self._pipe.error is not None:
            raise self._pipe.error

    def stop(self) -> None:
        self._stop.set()
