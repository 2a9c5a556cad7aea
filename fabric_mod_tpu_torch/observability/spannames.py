"""The span-name registry: every tracing span of the port, declared here.

The port's own copy of fabric_mod_tpu/observability/spannames.py
(`DECLARED_SPANS` :19), the same set.  Span names are the join key of the tracer: the
per-block timelines, the ``fabric_trace_substage_seconds{stage}``
histogram, the stage attribution that must explain the commit pipe's
stage, await and commit buckets, and the Chrome-trace export all select
spans BY NAME.  A test (tests/test_torch_tracing.py) holds both
directions: every ``tracing.span("...")`` literal in the port is
declared here, and every name declared here is used by a seam.
"""
from __future__ import annotations

from typing import Set

# Keep sorted.
DECLARED_SPANS: Set[str] = {
    "body_decode",
    "broadcast.handle",
    "broadcast.stage",
    "broadcast.submit",
    "der_marshal",
    "device_dispatch",
    "fanout.materialize",
    "fingerprint",
    "gossip.drain",
    "ledger_write",
    "mvcc",
    "mvcc_vector",
    "policy_device",
    "policy_finish",
    "policy_gather",
    "raft.replicate",
    "recv",
    "relay.push",
    "relay.repair",
    "shard.dispatch",
    "unpack",
    "verdict_await",
    "verify.flush",
    "verify.resolve",
    "wal.sync",
}


def is_declared(name: str) -> bool:
    return name in DECLARED_SPANS
