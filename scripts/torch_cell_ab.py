#!/usr/bin/env python3
"""Time one chip_smoke.py cell for two checkouts of the repository on
one CUDA card, in alternating turns within one run.

    python3 scripts/torch_cell_ab.py [--cell lifecycle|e2e-b|e2e-d]
                                     [--pairs N] [--trace] TREE_A TREE_B

Each TREE is the root of a checkout.  Each turn runs in a fresh
interpreter that imports TREE's own chip_smoke.py and
fabric_mod_tpu_torch (its kernels built under TREE/build/) and runs the
cell through chip_smoke's own functions:

- `lifecycle` (the default): phase 14's network set-up, (a) the
  lifecycle ceremony and (b) the full-width stream, as `--phase 14`
  runs them before its later parts: a solo e2e.Network on the card
  (tensor policy, staged ingress), LC_BLOCKS blocks of TX_PER_BLOCK
  endorsed txs over two namespaces, each block's flags held against the
  construction and a host oracle.  Reports (b)'s committed tx/s and ms
  a block staging and committing.
- `e2e-b`: phase 8 arm (b): a fresh solo e2e.Network, the Writers
  checks batched on the card, E2E_SUBMITTERS submitting threads,
  E2E_BLOCKS blocks of TX_PER_BLOCK txs endorsed in the turn, flags per
  txid against the construction.  Reports its committed tx/s over the
  ordering-and-commit span.
- `e2e-d`: phase 9 arm (d): as `e2e-b` on three Raft orderers, each
  with its own card-batched Writers check, the submitters spread
  round-robin over them.

The turns go A B, B A, A B, ... for N pairs (default 10).  Prints one
JSON line a turn and, at the end, each tree's median, quartiles and
range of tx/s.  `--trace` (lifecycle only) arms the tracer in every
turn and adds (b)'s seconds by span (observability/tracing.
substage_totals, read before and after (b)) to the turn's line.
chip_smoke's own log lines go to standard error.  Needs a card; exits
non-zero without one or on any failed check.
"""
import contextlib
import functools
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time


def lifecycle(cs, torch, dev, tracing, trace: bool) -> dict:
    pool = cs.PoolSwVerifier(cs.ORACLE_WORKERS)
    try:
        with tempfile.TemporaryDirectory() as root:
            lw = cs.LifecycleWorld(torch, dev, root, pool)
            try:
                cs.lc_ceremony(lw)
                before = _span_secs(tracing)
                f = cs.lc_stream(lw)
                after = _span_secs(tracing)
            finally:
                lw.close()
    finally:
        pool.close()
    row = {"tx_s": round(f["tx_s"], 1), "stage_ms": round(f["stage_ms"], 1),
           "commit_ms": round(f["commit_ms"], 1), "blocks": f["blocks"]}
    if trace:
        row["span_s"] = {k: round(v - before.get(k, 0.0), 4)
                         for k, v in sorted(after.items())
                         if v - before.get(k, 0.0) > 0}
    return row


def e2e(arm: str, cs, torch, dev, tracing, trace: bool) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cs.phase_e2e(torch, dev, arm=arm, n_blocks=cs.E2E_BLOCKS)
    text = out.getvalue()
    sys.stderr.write(text)
    rate = re.search(r"([0-9.]+) committed tx/s over the ordering-and-"
                     r"commit span of ([0-9.]+) s", text)
    ingress = re.search(r"ingress ([0-9.]+) s", text)
    return {"tx_s": float(rate.group(1)), "span_s": float(rate.group(2)),
            "ingress_s": float(ingress.group(1))}


CELLS = {"lifecycle": lifecycle, "e2e-b": functools.partial(e2e, "b"),
         "e2e-d": functools.partial(e2e, "d")}


def one_tree(tree: str, cell: str, trace: bool) -> None:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.observability import tracing
    from fabric_mod_tpu_torch.ops import _build
    tracing.enable(trace)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        _device.require_exact_fp32()
        dev = _device.resolve(None)
        _build.build_many()
        row = CELLS[cell](cs, torch, dev, tracing, trace)
    row = {"tree": tree, **row,
           "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(row), flush=True)


def _span_secs(tracing) -> dict:
    return {k: v["secs"] for k, v in tracing.substage_totals().items()}


def _quartiles(xs):
    xs = sorted(xs)

    def at(q):
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
    return {"min": xs[0], "q1": round(at(0.25), 1),
            "median": round(at(0.5), 1), "q3": round(at(0.75), 1),
            "max": xs[-1], "n": len(xs)}


def main() -> int:
    args = sys.argv[1:]
    cell, pairs, trace = "lifecycle", 10, False
    while args[:1] and args[0].startswith("--"):
        flag = args.pop(0)
        if flag == "--cell":
            cell = args.pop(0)
        elif flag == "--pairs":
            pairs = int(args.pop(0))
        elif flag == "--trace":
            trace = True
        elif flag == "--one":
            one_tree(args[0], cell, trace)
            return 0
        else:
            args = []
    if len(args) != 2 or cell not in CELLS or (trace and cell != "lifecycle"):
        print(__doc__, file=sys.stderr)
        return 2
    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    print(name, flush=True)
    trees = [os.path.abspath(t) for t in args]
    got = {t: [] for t in trees}
    for i in range(pairs):
        for tree in (trees if i % 2 == 0 else trees[::-1]):
            env = dict(os.environ, PYTHONPATH=tree)
            cmd = [sys.executable, os.path.abspath(__file__), "--cell", cell]
            cmd += ["--trace"] if trace else []
            out = subprocess.run(
                cmd + ["--one", tree], cwd=tree, env=env, check=True,
                timeout=900, stdout=subprocess.PIPE, text=True).stdout
            row = json.loads(out.strip().splitlines()[-1])
            row["turn"] = len(sum(got.values(), [])) + 1
            print(json.dumps(row), flush=True)
            got[tree].append(row["tx_s"])
    print(json.dumps({"tx_s": {t: _quartiles(v) for t, v in got.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
