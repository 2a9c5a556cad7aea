"""Channel-sharded scale-out: the port of fabric_mod_tpu/sharding/.

Channels placed on device slices behind one shared cross-channel verify
service:

* :mod:`shardmap` — deterministic channel -> slice placement with
  least-loaded assignment and bounded rebalance on leave;
* :mod:`router` — :class:`ChannelShardRouter`, which pins each
  channel's commit pipe and verify handle to its slice's verifier;
* :mod:`verifyservice` — :class:`CrossChannelVerifyService`, ONE
  flusher coalescing every channel's small verifies, split at flush
  time into per-slice groups that fail independently;
* :mod:`multihost` — the multi-host spec (a stub above one host, as in
  the reference).
"""
from fabric_mod_tpu_torch.sharding.shardmap import ShardMap          # noqa: F401
from fabric_mod_tpu_torch.sharding.router import (                   # noqa: F401
    ChannelShardRouter, ChannelVerifyHandle)
from fabric_mod_tpu_torch.sharding.verifyservice import (            # noqa: F401
    CrossChannelVerifyService)
from fabric_mod_tpu_torch.sharding.multihost import multihost_spec   # noqa: F401
