"""Deliver: stream committed blocks to consumers.

The port's copy of fabric_mod_tpu/orderer/deliver.py `DeliverService`
(:23; reference: common/deliver/deliver.go — Handle :157, deliverBlocks
:199 with SeekInfo semantics — serving the peer's deliver client).
`blocks` is a generator with the reference's seek semantics: a start
position, an optional stop, and a wait at the tip for new blocks.
"""
from __future__ import annotations

import threading
import time
from typing import Iterator, Optional

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.protos import messages as m

# how often a tip wait re-checks the stop event
_STOP_POLL_S = 0.25


class DeliverService:
    def __init__(self, support):
        self._support = support

    def blocks(self, start: int = 0, stop: Optional[int] = None,
               stop_event: Optional[threading.Event] = None,
               timeout_s: float = 30.0) -> Iterator[m.Block]:
        """Yield blocks [start, stop]; at the chain tip, wait for new
        blocks (SeekInfo BLOCK_UNTIL_READY) until `stop_event` fires or
        `timeout_s` passes without one."""
        num = start
        store = self._support.store
        cond = self._support.writer.height_changed
        while stop is None or num <= stop:
            if stop_event is not None and stop_event.is_set():
                return
            # chaos seam: a stream that dies mid-pull reaches the
            # consumer as a transport error would
            faults.point("deliver.stream")
            blk = store.get_block_by_number(num)
            if blk is not None:
                yield blk
                num += 1
                continue
            with cond:
                deadline = time.monotonic() + timeout_s
                while store.height <= num:
                    if stop_event is not None and stop_event.is_set():
                        return
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return            # idle timeout: end the stream
                    cond.wait(timeout=min(_STOP_POLL_S, remaining))
