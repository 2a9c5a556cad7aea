"""CancellationEvent: a threading.Event whose set() also runs hooks.

The port's copy of fabric_mod_tpu/concurrency/cancel.py.  A deliver
stream parks on the ledger's commit notifier; a plain Event used as the
stream's stop signal cannot wake that wait.  `on_set` registers a wake
hook (set a waiter's event) that fires exactly when the event is set,
so a parked stream can wait untimed and still stop promptly.  Hooks
must be cheap and non-blocking; their exceptions are swallowed so one
broken hook cannot mask the cancellation itself.
"""
from __future__ import annotations

import threading
from typing import Callable, List


class CancellationEvent(threading.Event):
    """An Event with set-time wake hooks (see module docstring)."""

    def __init__(self) -> None:
        super().__init__()
        self._hooks: List[Callable[[], None]] = []

    def on_set(self, hook: Callable[[], None]) -> Callable[[], None]:
        """Register `hook` to run at set() time; fires immediately if
        already set.  Returns an unsubscribe."""
        self._hooks.append(hook)
        if self.is_set():
            try:
                hook()
            except Exception:
                pass

        def unsubscribe() -> None:
            try:
                self._hooks.remove(hook)
            except ValueError:
                pass
        return unsubscribe

    def set(self) -> None:
        super().set()
        for hook in list(self._hooks):
            try:
                hook()
            except Exception:
                pass
