#!/usr/bin/env python3
"""Does torch.profiler see every launch of the port's hand-written kernels?

    PYTHONPATH=. python3 scripts/torch_lens_probe.py

On one CUDA card, the device lens (`GpuVerifier(profile_dir=...)` with
the tracer armed: one torch.profiler window, CPU and CUDA activities,
around one dispatch's marshal, launches and resolve) is opened twice
over the same 2048 lanes of a 1000-tx block's signatures (its endorser
lanes raw, so each dispatch launches SHA-256, the prologue, the ladder
and the epilogue once), with the libraries as ops/_build.py builds
them (nvcc's default, static CUDA runtime):

1. fresh — the process's first profiler window;
2. after a long window — a torch.profiler window over 50 dispatches
   first (its hand-written kernels counted in `prof.events()`, which
   chip_smoke's device_profile and kernel_intervals read, and in its
   Chrome trace), then the lens again.

Each lens window's kernels are also counted in `prof.events()`.

For each window it prints the kernels' launch counts over the window
and the kernel events in its Chrome trace, per kernel, and as its last
line one JSON object with both windows.  Exits non-zero without a
card.  The traces go to chiprun_out/lens_probe/.
"""
import json
import os
import subprocess
import sys
import time

import torch


def lens_window(gpu, tracing, verifier, items, out_dir):
    tracing.rearm_device_profile()
    verifier.profile_dir = out_dir
    with tracing.active():
        t0 = time.perf_counter()
        mask = verifier.verify_many(items)
        wall = time.perf_counter() - t0
    lens = tracing.last_lens()
    if lens is None or lens.path is None:
        raise RuntimeError("the lens opened no window")
    table = lens.kernel_table()
    return {"launches": lens.launches, "trace_kernels": lens.trace_kernels,
            "table": table, "complete": all(a == b for a, b in table.values()),
            "wall_s": wall, "trace": lens.path,
            "trace_bytes": os.path.getsize(lens.path)}, mask


def long_window(torch, tracing, verifier, items, path, n=50):
    """A profiler window over n dispatches: the hand-written kernels as
    `prof.events()` lists them (what chip_smoke's device_profile and
    kernel_intervals count) and as its Chrome trace holds them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            verifier.verify_many(items)
        torch.cuda.synchronize()
    names = ("ladder_", "verify_prologue", "verify_epilogue", "sha256_e")
    events = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name.startswith(names))
    prof.export_chrome_trace(path)
    in_trace = sum(tracing.trace_kernel_counts(path).values())
    return events, in_trace


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lens_probe: CUDA is not available", file=sys.stderr)
        return 2
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.observability import tracing
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.utils import fixtures
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    _device.require_exact_fp32()
    _build.build_many()
    items, expect = fixtures.make_block(3, n_tx=1000, raw_endorsers=True)
    items, expect = items[:2048], expect[:2048]
    verifier = gpu.GpuVerifier(cache_size=0)
    got = verifier.verify_many(items)              # warm: load, allocate
    if not (got == expect).all():
        raise AssertionError("verdicts differ from the construction")
    out = os.path.join("chiprun_out", "lens_probe")
    windows = {}
    for label, long_first in (("fresh", False), ("after_long", True)):
        if long_first:
            os.makedirs(os.path.join(out, "long"), exist_ok=True)
            events, in_trace = long_window(
                torch, tracing, verifier, items,
                os.path.join(out, "long", f"{label}.json"))
            print(f"{label}: the long window (50 dispatches, {50 * 4} "
                  f"launches): prof.events() lists {events} hand-written "
                  f"kernels, its Chrome trace {in_trace}", flush=True)
        res, mask = lens_window(gpu, tracing, verifier, items,
                                os.path.join(out, label))
        lens = tracing.last_lens()
        res["events_view"] = sum(
            1 for e in lens._prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name.startswith(("ladder_", "verify_", "sha256_e")))
        if not (mask == expect).all():
            raise AssertionError(f"{label}: verdicts differ")
        windows[label] = res
        print(f"{label}: {res['table']} complete={res['complete']}, "
              f"prof.events() lists {res['events_view']} of them; "
              f"trace {res['trace_bytes']} bytes, {res['wall_s']:.3f} s",
              flush=True)
    print(json.dumps({"device": smi, "windows": windows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
