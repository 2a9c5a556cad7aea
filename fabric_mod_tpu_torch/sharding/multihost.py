"""The multi-host sharding spec: the port's copy of
fabric_mod_tpu/sharding/multihost.py, which is a documented spec and a
stub in the reference too.

The design (why nothing above this layer changes): every host runs its
own ChannelShardRouter over the slices it PREFERS (the round robin
below); channel placement is deterministic (ShardMap is a pure function
of the join/leave sequence), so all hosts agree on the map without a
coordination service; the shared verify service stays per host, since
every host only verifies traffic it already holds.

Not built, here or in the reference: the multi-host bring-up itself
(process-group plumbing, restart semantics under churn) and a slice
spanning hosts.  `initialize_multihost` raises above one host.  The
reference's FABRIC_MOD_TPU_SHARD_HOSTS / _SHARDS knobs are arguments.
"""
from __future__ import annotations

from typing import Dict, List


def multihost_spec(n_hosts: int = 1, n_slices: int = 1) -> Dict:
    """The process-group spec a multi-host bring-up would follow: pure
    arithmetic, so tests pin its shape.

    Returns {hosts, slices, slices_per_host, process_groups:
    [{process_index, slices: [...]}], shardings, router} — slices are
    round-robin partitioned over hosts; the per-slice lane split is
    unchanged by design."""
    if n_hosts < 1 or n_slices < 1:
        raise ValueError("n_hosts and n_slices must be positive")
    if n_slices % n_hosts != 0:
        raise ValueError(
            f"{n_slices} slices do not partition over {n_hosts} hosts "
            f"evenly — pad the slice count, not the fleet")
    groups: List[Dict] = [
        {"process_index": p, "slices": list(range(p, n_slices, n_hosts))}
        for p in range(n_hosts)]
    return {
        "hosts": n_hosts,
        "slices": n_slices,
        "slices_per_host": n_slices // n_hosts,
        "process_groups": groups,
        "shardings": "identical per-slice lane split (parallel.lane_ranges: "
                     "contiguous lane ranges, one per device)",
        "router": "host-side, per-process, deterministic ShardMap",
    }


def initialize_multihost(n_hosts: int = 1) -> None:
    """The bring-up stub: a no-op on one host, NotImplementedError above
    it (as in the reference)."""
    if n_hosts <= 1:
        return
    raise NotImplementedError(
        "multi-host sharding is specified (sharding/multihost.py) but not "
        f"brought up (asked for {n_hosts} hosts)")
