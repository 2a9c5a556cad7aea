#!/usr/bin/env python3
"""Time the port's block commit for one or more checkouts of the
repository on one CUDA card, so that two commits can be compared in
turns within one run.

    python3 scripts/torch_commit_ab.py TREE [TREE ...]

Each TREE is the root of a checkout.  The trees run in the order given,
each in a fresh interpreter that imports TREE's own
fabric_mod_tpu_torch (its kernels built under TREE/build/).  The cell is
chip_smoke.py phase 5's: four 1000-tx blocks of
utils/fixtures.make_commit_blocks (3 orgs, OutOf(2, ...), a planted
invalid tx of each kind every 50 txs), committed into a fresh in-memory
ledger through GpuVerifier (projective ladder, no verdict cache) and
the tensor-policy evaluator: arm (a), and, where TREE's
CommitWorld.committer takes `vector_mvcc`, arm (e) with it on.  Each arm
runs the four blocks once to warm up, then once timed.  Per block it
prints the Committer's host ms by stage (stage, and its batch decode
where TREE records one; verify; policy; MVCC + commit) and checks the
txflags against the fixture's.  Needs a card; exits non-zero without
one or on any flag that differs.
"""
import inspect
import json
import os
import subprocess
import sys
import time

N_BLOCKS, TX_PER_BLOCK, PLANT_EVERY = 4, 1000, 50


def one_tree(tree: str) -> None:
    import torch

    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.utils import fixtures
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    _build.build_many()
    world = fixtures.make_commit_world()
    blocks, expected = fixtures.make_commit_blocks(
        world, N_BLOCKS, TX_PER_BLOCK, plant_every=PLANT_EVERY)
    arms = [("a", {})]
    if "vector_mvcc" in inspect.signature(
            fixtures.CommitWorld.committer).parameters:
        arms.append(("e", {"vector_mvcc": True}))
    for arm, kw in arms:
        for timed in (False, True):
            committer = world.committer(gpu.GpuVerifier(cache_size=0),
                                        tensor_policy=True, **kw)
            rows = []
            for raw, want in zip(blocks, expected):
                block = m.Block.decode(raw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if committer.store_block(block) != want:
                    raise SystemExit(f"{tree} arm {arm}: txflags differ")
                wall = time.perf_counter() - t0
                t = committer.last_timings
                rows.append({k: round(t[k] * 1e3, 1) for k in
                             ("stage", "decode", "verify", "policy", "commit")
                             if k in t} | {"wall": round(wall * 1e3, 1)})
        print(json.dumps({"tree": tree, "arm": arm, "ms_per_block": rows}),
              flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one_tree(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(name, flush=True)
    for tree in sys.argv[1:]:
        tree = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=tree)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        tree], cwd=tree, env=env, check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
