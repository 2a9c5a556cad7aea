#!/usr/bin/env python3
"""Time the verify core's prologue kernel (fabric_mod_tpu_torch/csrc/
p256_core.cu) on one CUDA card at other block geometries than the one
it ships with, to show which one the launcher should pick.

    PYTHONPATH=. python3 scripts/torch_core_geometry.py

The launcher gives each block width / SMs lanes (within [1, 32]).  This
script builds copies of the source whose launcher divides by K x SMs
instead (K = 1 is the shipped kernel; larger K: fewer lanes per block,
more blocks and warps per SM), under build/geometry/ (a directory
.gitignore lists), checks each copy's window planes and key_ok against
the shipped kernel's at 16 and 2048 lanes of utils/fixtures.
make_core_lanes, and prints each one's device time per call (CUDA
events around launches queued behind a sleep, chip_smoke.device_ms),
twice in turns.  Needs nvcc and a card; exits non-zero without them.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from fabric_mod_tpu_torch.ops import _build, p256, p256_core
from fabric_mod_tpu_torch.utils import fixtures

SPLITS = (1, 2, 4, 8, 16)
WIDTHS = (16, chip_smoke.LANES)
SHIPPED = "const int per = n / (sms > 0 ? sms : 1);"


def build_copies(out: Path) -> dict:
    src = _build.source_path("p256_core").read_text()
    if SHIPPED not in src:
        raise RuntimeError("the launcher's lanes-per-block line has changed")
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in SPLITS:
        cu = out / f"core_{k}.cu"
        cu.write_text(src.replace(
            SHIPPED, f"const int per = n / ({k} * (sms > 0 ? sms : 1));"))
        procs[k] = subprocess.Popen(
            [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(_build.CSRC),
             "-o", str(out / f"core_{k}.so"), str(cu)])
    launches = {}
    for k, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for K = {k}")
        fn = ctypes.CDLL(str(out / f"core_{k}.so")).p256_core_prologue_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        launches[k] = fn
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_core_geometry: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    launches = build_copies(_build.BUILD_DIR.parent / "geometry")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    planes, pre_ok, _ = fixtures.make_core_lanes(chip_smoke.LANES,
                                                 seed=b"smoke")
    _, range_ok, rn_lt_p = p256.range_checks(*planes)
    buf = torch.from_numpy(p256_core.pack(planes, range_ok, pre_ok,
                                          rn_lt_p)).cuda()
    want = p256_core.prologue(p256_core.rows(buf, p256_core.ROW_E), buf)
    stream = torch.cuda.current_stream().cuda_stream
    for rep in range(2):
        for k, fn in launches.items():
            for width in WIDTHS:
                sub = buf[:, :width].contiguous()
                e = p256_core.rows(sub, p256_core.ROW_E)
                u1 = torch.empty((p256.N_WINDOWS, width), dtype=torch.int32,
                                 device="cuda")
                u2 = torch.empty_like(u1)
                key_ok = torch.empty(width, dtype=torch.bool, device="cuda")
                args = (e.data_ptr(), sub.data_ptr(), u1.data_ptr(),
                        u2.data_ptr(), key_ok.data_ptr(), width, stream)
                if fn(*args) != 0:
                    raise RuntimeError(f"launch failed for K = {k}")
                torch.cuda.synchronize()
                for got, w in zip((u1, u2, key_ok), want):
                    if not torch.equal(got, w[..., :width]):
                        raise AssertionError(f"K = {k} differs at {width}")
                ms = chip_smoke.device_ms(torch, lambda: fn(*args))
                per = max(1, min(32, width // (k * n_sm)))
                print(f"turn {rep} K {k} width {width}: {per} lanes per "
                      f"block, {-(-width // per)} blocks; device {ms:.4f} "
                      f"ms per call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
