"""The fault-point registry: every injection point, declared here.

The port's copy of fabric_mod_tpu/faults/points.py.  `faults.point`
seams are named by strings, so a typo'd name in a plan would arm a rule
that never fires; declaring every point here makes
`FaultPlan.validate()` a complete check at arm time, and the port's
tests scan the package both ways (every declared point has a
`faults.point` literal, every literal is declared).

Three of the reference's points are not declared, each with its seam:

* ``bccsp.device.probe`` belongs to the circuit breaker's probe, and
  the port has no breaker: a device fault raises to the caller, it
  never degrades to a host verdict;
* ``deliver.failover.stream`` lives in peer/blocksprovider.py, which
  comes with the gRPC transport (``comm/``);
* ``gossip.comm.send`` lives in ``GRPCGossipNetwork``, also the gRPC
  transport's.

Tests arming synthetic points for framework units register them scoped
via :func:`declared_point`.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Set

# One line per seam; keep sorted.
DECLARED_POINTS: Set[str] = {
    "bccsp.device.dispatch",
    "bccsp.device.resolve",
    "commitpipe.commit",
    "commitpipe.stage",
    "deliver.fanout",
    "deliver.stream",
    "dissemination.push",
    "dissemination.repair",
    "gossip.comm.drop",
    "orderer.admission.overload",
    "orderer.broadcast.stage",
    "orderer.raft.replicate",
    "orderer.raft.submit",
    "orderer.wal.crash",
    "orderer.wal.sync",
    "peer.ledger.crash",
    "peer.mvcc.vector",
    "sharding.dispatch",
}


def is_declared(name: str) -> bool:
    return name in DECLARED_POINTS


@contextlib.contextmanager
def declared_point(name: str) -> Iterator[str]:
    """Scoped synthetic declaration for framework unit tests."""
    added = name not in DECLARED_POINTS
    if added:
        DECLARED_POINTS.add(name)
    try:
        yield name
    finally:
        if added:
            DECLARED_POINTS.discard(name)
