"""The port's concurrency-correctness package: guarded primitives and
dynamic race detection for every threaded structure of the port.

The port's copy of fabric_mod_tpu/concurrency/:

* `OrderedLock`      — ranked lock hierarchy (the rank check is always
                       on), also feeding the lock-order registry.
* `RegisteredLock`   — rankless re-entrant mutex; armed, it records
                       every observed acquisition ordering into one
                       process-wide graph and raises `RaceError` at the
                       acquire that closes a cycle.
* `GuardedQueue`     — queue.Queue whose consumer (and optionally
                       producer) side is pinned to one live thread.
* `OwnedState`       — field bag with single-writer thread ownership;
                       `claim()`/`release()` for scoped exclusivity.
* `ThreadOwnership`  — whole-structure pin (the Raft FSM contract).
* `RegisteredThread` — named worker registered for leak checking;
                       `assert_joined`, `live_registered`.
* `CancellationEvent` — the deliver streams' stop signal.

The reference arms the guards from FMT_RACECHECK at import; the port
reads no environment: `enable(True)` or `with armed():` arm them.
Disarmed, every guard is one module-flag read (a `RegisteredLock` is a
bare RLock acquire).
"""
from fabric_mod_tpu_torch.concurrency.cancel import CancellationEvent
from fabric_mod_tpu_torch.concurrency.core import (RaceError, armed, enable,
                                                   enabled)
from fabric_mod_tpu_torch.concurrency.locks import (LockOrderRegistry,
                                                    OrderedLock,
                                                    RegisteredLock,
                                                    lock_registry)
from fabric_mod_tpu_torch.concurrency.ownership import (OwnedState,
                                                        ThreadOwnership)
from fabric_mod_tpu_torch.concurrency.queues import GuardedQueue
from fabric_mod_tpu_torch.concurrency.threads import (RegisteredThread,
                                                      assert_joined,
                                                      live_registered)

__all__ = [
    "RaceError", "enabled", "enable", "armed", "CancellationEvent",
    "OrderedLock", "RegisteredLock", "LockOrderRegistry",
    "lock_registry",
    "GuardedQueue", "OwnedState", "ThreadOwnership",
    "RegisteredThread", "assert_joined", "live_registered",
]
