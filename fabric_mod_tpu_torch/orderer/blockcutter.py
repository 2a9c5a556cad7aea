"""Block cutting: batch envelopes by count and bytes.

The port's copy of fabric_mod_tpu/orderer/blockcutter.py (reference:
orderer/common/blockcutter/blockcutter.go — `Ordered` at :69 with its
three cut conditions, `Cut` at :127).  The batch timeout lives in the
consenter loop, not here, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from fabric_mod_tpu_torch.protos import messages as m


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """(reference: channelconfig BatchSize/BatchTimeout values)"""
    max_message_count: int = 500
    absolute_max_bytes: int = 10 * 1024 * 1024
    preferred_max_bytes: int = 2 * 1024 * 1024
    batch_timeout_s: float = 2.0


class BlockCutter:
    def __init__(self, config: BatchConfig):
        self.config = config
        self._pending: List[m.Envelope] = []
        self._pending_bytes = 0

    @property
    def pending(self) -> bool:
        return bool(self._pending)

    def ordered(self, env: m.Envelope
                ) -> Tuple[List[List[m.Envelope]], bool]:
        """Enqueue one message; returns (batches_to_cut, pending_left).

        Cut conditions (reference blockcutter.go:69-125):
          1. an oversized message (> preferred_max_bytes) cuts the
             pending batch and then rides alone;
          2. a message that would overflow preferred_max_bytes cuts
             the pending batch first;
          3. reaching max_message_count cuts immediately.
        """
        size = len(env.encode())
        batches: List[List[m.Envelope]] = []
        if size > self.config.preferred_max_bytes:
            if self._pending:
                batches.append(self.cut())
            batches.append([env])
            return batches, False
        if self._pending_bytes + size > self.config.preferred_max_bytes \
                and self._pending:
            batches.append(self.cut())
        self._pending.append(env)
        self._pending_bytes += size
        if len(self._pending) >= self.config.max_message_count:
            batches.append(self.cut())
        return batches, bool(self._pending)

    def cut(self) -> List[m.Envelope]:
        batch, self._pending = self._pending, []
        self._pending_bytes = 0
        return batch
