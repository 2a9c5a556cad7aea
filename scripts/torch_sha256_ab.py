#!/usr/bin/env python3
"""Time the raw lanes' SHA-256 kernel (fabric_mod_tpu_torch/csrc/sha256.cu)
against another version of the same source on one CUDA card, on the same
inputs, in turns: the other, this, this, the other.

    PYTHONPATH=. python3 scripts/torch_sha256_ab.py OTHER.cu

OTHER.cu is a sha256.cu with the same C entry `sha256_e_launch` (for
example an earlier commit's, from `git show
<commit>:fabric_mod_tpu_torch/csrc/sha256.cu`), built with nvcc under
build/sha256_ab/ (a directory .gitignore lists).  The inputs are
chip_smoke.py phase 3's main-path lanes: 2048 real creator and endorser
messages of the block-commit fixture, every lane raw.  Both kernels' e
rows must equal the plain version's; each is timed by
chip_smoke.device_ms (CUDA events around launches queued behind a
sleep).  Prints the card's name and power limit, each reading, and one
JSON line.  Needs nvcc and a card; exits non-zero without them.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from fabric_mod_tpu_torch import device as _device
from fabric_mod_tpu_torch.bccsp import der
from fabric_mod_tpu_torch.ops import _build, p256_core, sha256
from fabric_mod_tpu_torch.utils import fixtures

ORDER = ("other", "this", "this", "other")


def build_other(source: Path):
    out = _build.BUILD_DIR.parent / "sha256_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "sha256_other.so"
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(source)], check=True)
    fn = ctypes.CDLL(str(lib)).sha256_e_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_sha256_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    launches = {"other": build_other(Path(argv[1])),
                "this": _build.load("sha256").sha256_e_launch}
    world = fixtures.make_commit_world()
    blocks, _ = fixtures.make_commit_blocks(
        world, 1, chip_smoke.TX_PER_BLOCK, plant_every=chip_smoke.PLANT_EVERY)
    lanes = chip_smoke.LANES
    msgs = chip_smoke.commit_messages(blocks, lanes)
    words, nblocks, ok = der.pack_messages(msgs, lanes)
    if len(msgs) != lanes or not ok.all():
        raise AssertionError("expected 2048 packable messages")
    base = np.random.default_rng(chip_smoke.SEED).integers(
        -2**31, 2**31, (p256_core.ROWS, lanes)).astype(np.int32)
    base[p256_core.ROW_FLAGS] = (p256_core.FLAG_HAS_MSG
                                 | p256_core.FLAG_RANGE_OK)
    dev = torch.device("cuda")
    w = _device.upload(words.view(np.int32), dev)
    nb = _device.upload(nblocks, dev)
    buf0 = torch.from_numpy(base).to(dev)
    want = sha256.sha256_e_plain(w, nb, buf0.clone())
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in launches.items():
        out = buf0.clone()
        if fn(w.data_ptr(), nb.data_ptr(), words.shape[1], out.data_ptr(),
              lanes, stream) != 0:
            raise AssertionError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: e rows differ from plain")
    scratch = buf0.clone()
    readings = []
    for name in ORDER:
        fn = launches[name]
        ms = chip_smoke.device_ms(torch, lambda: fn(
            w.data_ptr(), nb.data_ptr(), words.shape[1], scratch.data_ptr(),
            lanes, stream))
        readings.append([name, ms])
        print(f"{name}: {ms:.5f} ms per call (device, "
              f"{chip_smoke.DEVICE_REPS} launches behind a sleep)")
    print(json.dumps({"card": smi, "lanes": lanes,
                      "blocks_max": int(nblocks.max()),
                      "blocks_mean": float(nblocks.mean()),
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
