"""RegisteredThread: named workers with teardown leak checking.

The port's copy of fabric_mod_tpu/concurrency/threads.py.  Every
long-lived worker of the port runs as a RegisteredThread: it registers
while alive, under the `structure` name of its owning component, and a
structure's close() may call `assert_joined` on its own workers — with
the guards armed (concurrency.enable), a worker that outlives its
structure's teardown raises RaceError naming it.  `live_registered()`
is the leak sweep the soak runs at teardown (soak/invariants.py).
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from fabric_mod_tpu_torch.concurrency.core import RaceError, enabled

_mu = threading.Lock()
_live: "set[RegisteredThread]" = set()


class RegisteredThread(threading.Thread):
    """A named daemon worker registered for leak accounting.

    `structure` names the owning component (for the leak report);
    threads register at start() and deregister when run() returns.
    """

    def __init__(self, target, name: str, structure: str = "",
                 args: tuple = (), daemon: bool = True):
        super().__init__(target=target, name=name, args=args,
                         daemon=daemon)
        self.structure = structure or name

    def start(self) -> None:
        with _mu:
            _live.add(self)
        super().start()

    def run(self) -> None:
        try:
            super().run()
        finally:
            with _mu:
                _live.discard(self)


def live_registered() -> List[RegisteredThread]:
    """Registered threads that are currently alive."""
    with _mu:
        return [t for t in _live if t.is_alive()]


def assert_joined(threads: Sequence[threading.Thread], owner: str,
                  timeout: Optional[float] = 5.0) -> None:
    """Join `threads`; with the guards armed, raise RaceError naming any
    that are still alive.  With guards off this is just the bounded
    joins."""
    for t in threads:
        if t is threading.current_thread():
            continue                      # self-join would deadlock
        t.join(timeout=timeout)
    if not enabled():
        return
    leaked = [t for t in threads
              if t is not threading.current_thread() and t.is_alive()]
    if leaked:
        names = ", ".join(repr(t.name) for t in leaked)
        raise RaceError(
            f"thread leak at teardown of {owner}: worker(s) {names} "
            f"still alive after join(timeout={timeout})")
