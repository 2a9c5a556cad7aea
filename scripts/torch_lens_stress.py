#!/usr/bin/env python3
"""After what does torch.profiler stop recording the device's activity?

    PYTHONPATH=. python3 scripts/torch_lens_stress.py

On one CUDA card, one process: the device lens (an armed
`GpuVerifier(profile_dir=...)` dispatch of 2048 lanes of a 1000-tx
block, endorser lanes raw: SHA-256, prologue, ladder, epilogue) is
opened fresh, then again after each of these in turn:

1. threaded — a profiler window in which 4 threads each make 5
   dispatches (the launches come from threads other than the one that
   opened the window, as in the commit pipe);
2. many — 30 short profiler windows, one dispatch each;
3. big — one profiler window over 200,000 small torch ops on the card;
4. plain pairing — a profiler window over one plain (torch ops) pairing
   check of 64 lanes, ~143k launches.

For each window it prints the hand-written kernels' launches against
the trace's kernel events, and the trace's GPU memcpy events (activity
of any kind recorded on the device), and for each stressor window the
same counts from `prof.events()`; last, one JSON line.  Exits non-zero
without a card.  Traces go to chiprun_out/lens_stress/.
"""
import json
import os
import subprocess
import sys
import threading
import time

import torch


def trace_counts(tracing, path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {"kernels": sum(tracing.trace_kernel_counts(path).values()),
            "memcpy": sum(1 for e in events if e.get("cat") == "gpu_memcpy"),
            "all_gpu": sum(1 for e in events
                           if e.get("cat") in ("kernel", "gpu_memcpy",
                                               "gpu_memset"))}


def lens(tracing, verifier, items, out_dir):
    tracing.rearm_device_profile()
    verifier.profile_dir = out_dir
    with tracing.active():
        verifier.verify_many(items)
    got = tracing.last_lens()
    return {"table": got.kernel_table(),
            "complete": all(a == b for a, b in got.kernel_table().values()),
            **trace_counts(tracing, got.path)}


def window(torch, tracing, gpu, fn, path):
    """fn() under a profiler window: launches counted, kernel events
    listed by prof.events() and in the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    before = gpu.kernel_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched = sum(v - before[k] for k, v in gpu.kernel_counts().items())
    listed = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name.startswith(("ladder_", "verify_", "sha256_e")))
    prof.export_chrome_trace(path)
    return {"launched": launched, "events_listed": listed,
            **trace_counts(tracing, path)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lens_stress: CUDA is not available", file=sys.stderr)
        return 2
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.observability import tracing
    from fabric_mod_tpu_torch.ops import _build, fp256bn_dev
    from fabric_mod_tpu_torch.utils import fixtures
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    _device.require_exact_fp32()
    _build.build_many()
    out = os.path.join("chiprun_out", "lens_stress")
    os.makedirs(out, exist_ok=True)
    items, _expect = fixtures.make_block(3, n_tx=1000, raw_endorsers=True)
    items = items[:2048]
    verifier = gpu.GpuVerifier(cache_size=0)
    verifier.verify_many(items)
    dev = torch.device("cuda")
    idemix = fixtures.make_idemix_world(seed=3, n_users=1)
    lanes = fixtures.make_pairing_lanes(idemix, 64)

    def threaded():
        ts = [threading.Thread(target=lambda: [
            verifier.verify_many(items) for _ in range(5)])
            for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    def many():
        return [window(torch, tracing, gpu, lambda: verifier.verify_many(
            items), os.path.join(out, f"many_{i}.json")) for i in range(30)]

    def big():
        x = torch.zeros(16, device=dev)
        for _ in range(200_000):
            x.add_(1)

    ik = idemix.issuer.key
    neg = [p.neg() for p in lanes[1]]

    def plain_pairing():
        fp256bn_dev.pairing_check_plain(lanes[0], ik.W, neg, ik.g2,
                                        device=dev)
    stages = {"fresh": lens(tracing, verifier, items,
                            os.path.join(out, "lens_fresh"))}
    print(f"fresh: {stages['fresh']}", flush=True)
    stress = {}
    for name, fn in (("threaded", threaded), ("many", None), ("big", big),
                     ("plain_pairing", plain_pairing)):
        t0 = time.perf_counter()
        if name == "many":
            res = many()[-1]
        else:
            res = window(torch, tracing, gpu, fn,
                         os.path.join(out, f"{name}.json"))
        res["wall_s"] = time.perf_counter() - t0
        stress[name] = res
        stages[name] = lens(tracing, verifier, items,
                            os.path.join(out, f"lens_after_{name}"))
        print(f"{name}: window {res}; lens after it {stages[name]}",
              flush=True)
    print(json.dumps({"device": smi, "lens": stages, "windows": stress}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
