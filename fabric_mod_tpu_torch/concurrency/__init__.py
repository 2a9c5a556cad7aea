"""The worker-thread registry of the port's concurrency package.

The port's copy of fabric_mod_tpu/concurrency/'s `RegisteredThread`,
`live_registered`, `assert_joined`, `RaceError` and the arming gate
(`enable`, `enabled`, `armed`).  Every long-lived worker of the port is
a RegisteredThread, so a teardown sweep sees them all.  The lock-order
registry, `GuardedQueue` and the ownership wrappers are still to port.
`CancellationEvent` (the deliver streams' stop signal) is here too.
"""
from fabric_mod_tpu_torch.concurrency.cancel import CancellationEvent
from fabric_mod_tpu_torch.concurrency.core import (RaceError, armed, enable,
                                                   enabled)
from fabric_mod_tpu_torch.concurrency.threads import (RegisteredThread,
                                                      assert_joined,
                                                      live_registered)

__all__ = [
    "RaceError", "enabled", "enable", "armed", "CancellationEvent",
    "RegisteredThread", "assert_joined", "live_registered",
]
