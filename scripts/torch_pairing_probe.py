#!/usr/bin/env python3
"""Where a round of the idemix pairing kernels' programs goes, on one CUDA
card: clock64 readings from scripts/pairing_latency_probe.cu (which
includes fabric_mod_tpu_torch/csrc/fp256bn_pairing.cu).

    PYTHONPATH=. python3 scripts/torch_pairing_probe.py

Prints the card's name and power limit; the cycles of one Fp product and
one square in a chain of dependent ones, on 1 warp and on 528 (4 an SM);
and, for each Fp12 program, the cycles of one run in one block and of
each of its stages (its rounds of products, its output sums), with the
argument table's write.  Builds with nvcc under build/pairing_probe/ (a
directory .gitignore lists).  Needs nvcc and a card; exits non-zero
without them.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from fabric_mod_tpu_torch.ops import _build
from fabric_mod_tpu_torch.ops import fp256bn_programs as programs

SOURCE = Path(__file__).resolve().parent / "pairing_latency_probe.cu"
ITERS = 200
REPS = 20
KINDS = ("mul", "sqr", "inv", "sum")


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "pairing_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "pairing_latency_probe.so"
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.pairing_probe_products.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, P, P]
    lib.pairing_probe_program.argtypes = [ctypes.c_int, ctypes.c_int, P]
    lib.pairing_probe_products.restype = ctypes.c_int
    lib.pairing_probe_program.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pairing_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    lib = build()
    d = torch.device("cuda")
    cyc = torch.zeros(1024, dtype=torch.int64, device=d)
    sink = torch.zeros(1024 * 32, dtype=torch.int32, device=d)
    for blocks in (1, 528):
        for square in (0, 1):
            rc = lib.pairing_probe_products(blocks, ITERS, square,
                                            cyc.data_ptr(), sink.data_ptr())
            if rc:
                raise RuntimeError(f"pairing_probe_products: cudaError {rc}")
            c = cyc[:blocks].double().mean().item() / ITERS
            print(f"{'square' if square else 'product'} chain on {blocks} "
                  f"warps: {c:.0f} cycles each")
    for name in programs.PROGRAM_ORDER:
        if not name.startswith("f12_") or "mont" in name:
            continue
        cyc.zero_()
        rc = lib.pairing_probe_program(programs.PROGRAM_ORDER.index(name),
                                       REPS, cyc.data_ptr())
        if rc:
            raise RuntimeError(f"pairing_probe_program: cudaError {rc}")
        c = [v / REPS for v in cyc[:16].tolist()]
        stages = ", ".join(
            f"{KINDS[kind]} x{len(items)} {c[2 + s]:.0f}"
            for s, (kind, items) in enumerate(programs.PROGRAMS[name].stages))
        print(f"{name}: {c[0]:.0f} cycles a run (argument table "
              f"{c[1]:.0f}; stages: {stages})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
