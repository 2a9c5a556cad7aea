"""Shared retry policy: jittered exponential backoff with deadlines.

The port's copy of fabric_mod_tpu/utils/retry.py (reference: the
backoff loops Fabric scatters per subsystem — blocksprovider.go:141's
deliver retry, comm/connection.go's dial retry, etcdraft's submit
re-forwarding — folded into one policy object).

Determinism: `clock`, `sleep` and `rng` are injectable.  A test passes
a seeded `random.Random` for a reproducible jitter sequence and a
`sleep` that advances a utils/fakeclock.ManualClock, so retry waits
drive fake time instead of stalling on real sleeps.  The defaults of
`base_s` and `max_s` are the reference's (its
FABRIC_MOD_TPU_RETRY_BASE_S and _MAX_S knobs); nothing is read from the
environment.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)

BASE_S = 0.05
MAX_S = 5.0

_RETRIES_OPTS = MetricOpts(
    "fabric", "retry", "attempts_total",
    help="Retry attempts taken (first tries excluded), per policy name.",
    label_names=("name",))
_GIVEUPS_OPTS = MetricOpts(
    "fabric", "retry", "giveups_total",
    help="Operations abandoned after exhausting retries/deadline, per "
         "policy name.",
    label_names=("name",))


@functools.lru_cache(maxsize=None)
def _metrics():
    prov = default_provider()
    return prov.counter(_RETRIES_OPTS), prov.counter(_GIVEUPS_OPTS)


class RetryBudgetExceeded(Exception):
    """Retries/deadline exhausted; `last` carries the final attempt's
    exception (also chained as __cause__)."""

    def __init__(self, msg: str, last: Optional[BaseException] = None):
        super().__init__(msg)
        self.last = last


class Retrier:
    """Jittered-exponential-backoff retry with an overall deadline.

    delay(attempt) = min(max_s, base_s * multiplier**attempt) scaled by
    a jitter factor uniform in [1-jitter, 1+jitter]; attempt 0 is the
    first retry (the second try).  `deadline_s` bounds the whole call()
    from first attempt to last raise; `max_attempts` bounds total tries.
    """

    def __init__(self, base_s: float = BASE_S, max_s: float = MAX_S,
                 multiplier: float = 2.0, jitter: float = 0.1,
                 deadline_s: Optional[float] = None,
                 max_attempts: Optional[int] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 clock=None, sleep: Optional[Callable[[float], None]] = None,
                 rng: Optional[random.Random] = None,
                 giveup: Optional[Callable[[], bool]] = None,
                 on_retry: Optional[Callable[[BaseException, int], None]]
                 = None, name: str = "retry"):
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.base_s = base_s
        self.max_s = max_s
        self.multiplier = multiplier
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.max_attempts = max_attempts
        self.retry_on = retry_on
        self.name = name
        self._clock = clock or time
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = rng or random.Random()
        self._giveup = giveup
        self._on_retry = on_retry
        self._m_retries, self._m_giveups = _metrics()

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry #`attempt` (0-based), jitter applied.
        The exponent is clamped so a long outage cannot overflow the
        float."""
        exp = min(60, max(0, attempt))
        raw = min(self.max_s, self.base_s * (self.multiplier ** exp))
        if self.jitter:
            raw *= 1.0 + self.jitter * (self._rng.random() * 2.0 - 1.0)
        return max(0.0, raw)

    def worst_case_delay(self, attempts: Optional[int] = None) -> float:
        """Upper bound on total sleep across `attempts` retries."""
        n = attempts if attempts is not None else (self.max_attempts or 1)
        total = 0.0
        for i in range(max(0, n)):
            exp = min(60, i)
            total += min(self.max_s,
                         self.base_s * (self.multiplier ** exp))
        return total * (1.0 + self.jitter)

    def call(self, fn: Callable, *args, **kwargs):
        """Run `fn` until it returns, an un-retryable exception raises,
        or the budget (deadline/max_attempts/giveup) is exhausted — then
        the last exception re-raises (typed errors like NotLeaderError
        stay catchable)."""
        start = self._clock.monotonic()
        attempt = 0                        # retries taken so far
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                out_of_attempts = (self.max_attempts is not None
                                   and attempt + 1 >= self.max_attempts)
                gave_up = self._giveup is not None and self._giveup()
                if out_of_attempts or gave_up:
                    self._m_giveups.with_labels(self.name).add(1)
                    raise
                delay = self.delay_for(attempt)
                if self.deadline_s is not None:
                    elapsed = self._clock.monotonic() - start
                    # a retry that cannot start before the deadline is
                    # not taken: the deadline bounds the whole call
                    if elapsed + delay >= self.deadline_s:
                        self._m_giveups.with_labels(self.name).add(1)
                        raise
                if self._on_retry is not None:
                    self._on_retry(e, attempt)
                if delay > 0:
                    self._sleep(delay)
                attempt += 1
                self._m_retries.with_labels(self.name).add(1)
