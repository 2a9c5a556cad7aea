"""Race-detection primitives — compatibility shim.

The port's copy of fabric_mod_tpu/utils/racecheck.py.  The detectors
live in the port's concurrency package (`fabric_mod_tpu_torch.
concurrency`: guarded queues, field-level ownership, registered threads
and the lock-order registry with cycle detection).  This module keeps
the original import surface of the ledger and Raft call sites; new code
imports from the concurrency package directly.
"""
from fabric_mod_tpu_torch.concurrency import (OrderedLock, RaceError,
                                              ThreadOwnership)

__all__ = ["OrderedLock", "RaceError", "ThreadOwnership"]
