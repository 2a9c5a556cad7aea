#!/usr/bin/env python3
"""What the port's concurrency guards cost with the guards off.

    python3 scripts/torch_guard_cost.py [--pairs N] [--blocks B]
                                        [--tx T] [--device cpu|cuda]

Two parts, one JSON line at the end:

1. ns a call, the least of 5 rounds of N calls (default 200,000) on one
   thread: a `with` block over threading.Lock, threading.RLock,
   RegisteredLock and OrderedLock (guards off, and RegisteredLock with
   the guards armed); a put + get over queue.Queue and GuardedQueue; one
   ThreadOwnership.guard() of a claimed owner.
2. how often a full-width commit takes them: a solo e2e.Network on the
   card's GpuVerifier (fixtures' seeded three-org material, T txs a
   block, default 1000), B blocks (default 2) of blind puts hand-signed
   by Org1 and Org2, broadcast from one thread, ordered and committed,
   with the calls of RegisteredLock, OrderedLock, GuardedQueue and
   ThreadOwnership.guard counted, by class and by structure name (the
   counting wrapper runs only here).

The line's `added_us_a_block` is each structure's calls a block times
its ns over the bare lock or queue it replaced (RegisteredLock and
OrderedLock over threading.Lock, GuardedQueue over queue.Queue, guard()
over nothing), beside the commit's ms a block (the ordering-and-commit
span over B).  `--device cpu` runs part 2 on the host (GpuVerifier's
plain version) at a size the caller picks.
"""
import argparse
import json
import os
import queue
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fabric_mod_tpu_torch import concurrency  # noqa: E402
from fabric_mod_tpu_torch.concurrency import (GuardedQueue,  # noqa: E402
                                              OrderedLock, RegisteredLock,
                                              ThreadOwnership)

ROUNDS = 5


def _ns_a_call(fn, n: int) -> float:
    best = float("inf")
    for _ in range(ROUNDS):
        t0 = time.perf_counter_ns()
        fn(n)
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def _with_loop(lock):
    def run(n):
        for _ in range(n):
            with lock:
                pass
    return run


def _queue_loop(q):
    def run(n):
        for _ in range(n):
            q.put(None)
            q.get()
    return run


def _guard_loop(own):
    def run(n):
        g = own.guard
        for _ in range(n):
            g()
    return run


def per_call_ns(n: int) -> dict:
    own = ThreadOwnership("bench")
    own.claim()
    out = {
        "Lock": _ns_a_call(_with_loop(threading.Lock()), n),
        "RLock": _ns_a_call(_with_loop(threading.RLock()), n),
        "RegisteredLock": _ns_a_call(_with_loop(RegisteredLock("bench")), n),
        "OrderedLock": _ns_a_call(_with_loop(OrderedLock(10, "bench")), n),
        "Queue": _ns_a_call(_queue_loop(queue.Queue()), n),
        "GuardedQueue": _ns_a_call(_queue_loop(GuardedQueue(name="bench")),
                                   n),
        "guard": _ns_a_call(_guard_loop(own), n),
    }
    with concurrency.armed():
        out["RegisteredLock_armed"] = _ns_a_call(
            _with_loop(RegisteredLock("bench-armed")), n)
    return {k: round(v, 1) for k, v in out.items()}


def _counting(counts: dict, by_name: dict):
    """Wrap the guarded structures' entry points to count their calls,
    by class into `counts` and by structure name into `by_name`;
    returns the undo."""
    patched = []

    def wrap(cls, attr, key):
        orig = cls.__dict__[attr]

        def counted(self, *a, **kw):
            counts[key] += 1
            by_name[self.name] = by_name.get(self.name, 0) + 1
            return orig(self, *a, **kw)
        setattr(cls, attr, counted)
        patched.append((cls, attr, orig))

    for cls, key in ((RegisteredLock, "RegisteredLock"),
                     (OrderedLock, "OrderedLock")):
        wrap(cls, "acquire", key)
        wrap(cls, "__enter__", key)
    wrap(GuardedQueue, "put", "GuardedQueue")
    wrap(ThreadOwnership, "guard", "guard")

    def undo():
        for cls, attr, orig in patched:
            setattr(cls, attr, orig)
    return undo


def commit_counts(device: str, n_blocks: int, tx: int) -> dict:
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.utils import fixtures
    material = fixtures.make_network_material(
        0, max_message_count=tx, batch_timeout="2s",
        preferred_max_bytes=64 * 1024 * 1024)
    world = fixtures.network_world(material)
    envs = fixtures.make_put_txs(
        world, [(fixtures.NAMESPACE, f"g{i}", b"v%d" % i, ("Org1", "Org2"))
                for i in range(n_blocks * tx)], b"guard-cost")
    counts = dict.fromkeys(("RegisteredLock", "OrderedLock", "GuardedQueue",
                            "guard"), 0)
    by_name: dict = {}
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=material, device=device)
        try:
            undo = _counting(counts, by_name)
            try:
                _client, got, span = e2e.commit_until(
                    net, len(envs), 600.0,
                    feed=lambda: e2e.submit_all(net, envs),
                    idle_timeout_s=60.0)
            finally:
                undo()
            height = net.ledger.height
        finally:
            net.close()
    if got != len(envs) or height != 1 + n_blocks:
        raise SystemExit(f"committed {got} of {len(envs)} txs, height "
                         f"{height}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"calls_a_block": {k: v / n_blocks for k, v in counts.items()},
            "top_structures_a_block": {k: v / n_blocks for k, v in top},
            "commit_ms_a_block": round(span / n_blocks * 1e3, 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=200_000)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--tx", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
    ns = per_call_ns(args.pairs)
    commit = commit_counts(args.device, args.blocks, args.tx)
    bare = {"RegisteredLock": ns["Lock"], "OrderedLock": ns["Lock"],
            "GuardedQueue": ns["Queue"], "guard": 0.0}
    added = {k: round(c * (ns[k] - bare[k]) / 1e3, 1)
             for k, c in commit["calls_a_block"].items()}
    print(json.dumps({"ns_a_call": ns, **commit,
                      "added_us_a_block": added,
                      "added_us_a_block_total": round(sum(added.values()),
                                                      1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
