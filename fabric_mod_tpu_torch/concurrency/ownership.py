"""Thread-ownership guards: whole-structure and field-level.

The port's copy of fabric_mod_tpu/concurrency/ownership.py.

``ThreadOwnership`` (from the original utils/racecheck.py) pins a
whole structure to its FSM/worker thread.  ``OwnedState`` is the
field-level generalization the retrofits need: a small bag of fields
whose WRITES are pinned to one owning thread while reads stay open
(single-writer/multi-reader is the actual contract of the pipeline
timing counters, the puller's chain cursor, the election verdict) —
plus ``claim()``/``release()`` for scoped exclusivity, so "two
concurrent run() loops on one client" is a detected race instead of
silent double-submission.
"""
from __future__ import annotations

import threading
from typing import Optional

from fabric_mod_tpu_torch.concurrency.core import RaceError, enabled


class ThreadOwnership:
    """Pins a structure to one owning thread.  `claim()` binds the
    current thread (the FSM/worker thread at startup); `guard()`
    raises when any OTHER thread enters a guarded section.  The
    raft FSM's whole design contract — all state transitions on the
    FSM thread (chain.go:533's single-threaded run loop) — becomes
    machine-checked instead of a docstring.

    Always armed once claimed (production raft runs it live); `live_only=True` relaxes guard()
    to pass when the claimed owner thread has terminated — the
    teardown-then-reuse pattern of the pooled structures."""

    def __init__(self, name: str = "structure", live_only: bool = False):
        self.name = name
        self._owner: Optional[int] = None
        self._owner_thread: Optional[threading.Thread] = None
        self._live_only = live_only

    def claim(self) -> None:
        self._owner = threading.get_ident()
        self._owner_thread = threading.current_thread()

    def guard(self) -> None:
        if self._owner is None:
            return                        # not yet claimed (startup)
        me = threading.get_ident()
        if me != self._owner:
            if self._live_only and self._owner_thread is not None \
                    and not self._owner_thread.is_alive():
                return                    # owner terminated: handoff
            raise RaceError(
                f"thread-ownership violation: {self.name} touched "
                f"from thread {me}, owned by {self._owner}")


class OwnedState:
    """Field bag with single-writer thread ownership.

    Construct with the initial fields (``OwnedState("name", x=0)``) —
    construction does NOT claim ownership (builders routinely init on
    the caller thread and hand the state to a worker).  With the
    guards armed, the first post-construction write claims the writing
    thread; any later write from a different LIVE thread raises.
    Reads are deliberately unguarded: the retrofitted fields are
    monotonic counters/cursors whose cross-thread reads are benign,
    and guarding them would outlaw the metrics/bench surfaces.

    ``claim()``/``release()`` pin explicitly for scoped exclusivity
    (a second concurrent claim from a live thread raises — the
    double-run detector).
    """

    _INTERNAL = ("_os_name", "_os_owner", "_os_lock")

    def __init__(self, name: str, **fields):
        object.__setattr__(self, "_os_name", name)
        object.__setattr__(self, "_os_owner", None)
        # serializes check-then-adopt: without it two threads racing
        # claim() (or two first writes) could BOTH pass the owner
        # check — the detector missing exactly the concurrent entry
        # it exists to catch.  Armed-path only; disarmed claims skip it
        object.__setattr__(self, "_os_lock", threading.Lock())
        for k, v in fields.items():
            object.__setattr__(self, k, v)

    # -- explicit scope ----------------------------------------------------
    def claim(self) -> None:
        if enabled():
            with self._os_lock:
                self._check_claim()
                object.__setattr__(self, "_os_owner",
                                   threading.current_thread())
            return
        object.__setattr__(self, "_os_owner",
                           threading.current_thread())

    def release(self) -> None:
        object.__setattr__(self, "_os_owner", None)

    def _check_claim(self) -> None:
        owner = self._os_owner
        me = threading.current_thread()
        if owner is not None and owner is not me and owner.is_alive():
            raise RaceError(
                f"concurrent ownership of {self._os_name}: thread "
                f"{me.name!r} claiming while live thread "
                f"{owner.name!r} still owns it")

    # -- guarded writes ----------------------------------------------------
    def __setattr__(self, key, value):
        if key in self._INTERNAL:
            object.__setattr__(self, key, value)
            return
        if enabled():
            me = threading.current_thread()
            with self._os_lock:
                owner = self._os_owner
                if owner is me:
                    pass
                elif owner is None or not owner.is_alive():
                    object.__setattr__(self, "_os_owner", me)
                else:
                    raise RaceError(
                        f"field-ownership violation on "
                        f"{self._os_name}.{key}: written from thread "
                        f"{me.name!r}, owned by live thread "
                        f"{owner.name!r}")
        object.__setattr__(self, key, value)
