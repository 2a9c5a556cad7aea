#!/usr/bin/env python3
"""Time the idemix pairing kernels (fabric_mod_tpu_torch/csrc/
fp256bn_pairing.cu) against another version of the same source on one
CUDA card, on the same inputs, in turns: the other, this, this, the other.

    PYTHONPATH=. python3 scripts/torch_pairing_ab.py OTHER_DIR [OTHER_DIR ...]

Each OTHER_DIR holds another version's fp256bn_pairing.cu and the headers
it includes (for example an earlier commit's csrc/, from `git archive`),
with the same C entries `fp256bn_miller_launch` and
`fp256bn_final_exp_launch`; it is built with nvcc under build/pairing_ab/
(a directory .gitignore lists).  The inputs are chip_smoke.py phase 7's:
1024 lanes of utils/fixtures.make_pairing_lanes (every 97th tampered)
against the issuer's W and g2, and their first 63 lanes (the check of 64
presentations).  Both versions' verdicts must equal the construction's
and their Miller words each other's; each kernel is timed by
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
from fabric_mod_tpu_torch.ops import _build
from fabric_mod_tpu_torch.ops import fp256bn_cuda as cuda
from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
from fabric_mod_tpu_torch.utils import fixtures

ORDER = ("other", "this", "this", "other")
WIDTHS = (chip_smoke.IDEMIX_LANES, chip_smoke.IDEMIX_PRESENTATIONS - 1)
REPS = 5


def build_other(source_dir: Path, tag: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "pairing_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"fp256bn_pairing_{tag}.so"
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(source_dir / "fp256bn_pairing.cu")], check=True)
    other = ctypes.CDLL(str(lib))
    for fn in ("fp256bn_miller_launch", "fp256bn_final_exp_launch"):
        res, args = _build.SIGNATURES["fp256bn_pairing"][fn]
        getattr(other, fn).restype = res
        getattr(other, fn).argtypes = args
    return other


def launches(lib, pts, lines, is_add, f, ok, stream):
    """The two kernels' launches of `lib` on these planes."""
    n = pts.shape[-1]

    def miller():
        rc = lib.fp256bn_miller_launch(pts.data_ptr(), lines.data_ptr(),
                                       is_add.data_ptr(), is_add.shape[0],
                                       f.data_ptr(), n, 2, stream)
        if rc:
            raise RuntimeError(f"fp256bn_miller launch failed: {rc}")

    def final_exp():
        rc = lib.fp256bn_final_exp_launch(f.data_ptr(), 1, ok.data_ptr(), 0,
                                          n, stream)
        if rc:
            raise RuntimeError(f"fp256bn_final_exp launch failed: {rc}")
    return miller, final_exp


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_pairing_ab: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    d = torch.device("cuda")
    libs = {"this": _build.load("fp256bn_pairing")}
    world = fixtures.make_idemix_world(chip_smoke.SEED)
    ik = world.issuer.key
    a_pts, abar, expect = fixtures.make_pairing_lanes(
        world, chip_smoke.IDEMIX_LANES, chip_smoke.IDEMIX_TAMPER_EVERY,
        seed=chip_smoke.SEED)
    neg = [p.neg() for p in abar]
    s1, s2 = dev.line_schedule(ik.W), dev.line_schedule(ik.g2)
    lines = _device.upload(np.stack([s1.line_words(), s2.line_words()]), d)
    is_add = _device.upload(s1.is_add.astype(np.int32), d)
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for i, other_dir in enumerate(argv[1:]):
        libs["other"] = build_other(Path(other_dir), str(i))
        for n in WIDTHS:
            pts = _device.upload(np.stack([cuda.point_words(a_pts[:n]),
                                           cuda.point_words(neg[:n])]), d)
            words = {}
            row = {"other": other_dir, "lanes": n}
            for turn, who in enumerate(ORDER):
                f = torch.empty((2, 12, 8, n), dtype=torch.int32, device=d)
                ok = torch.empty(n, dtype=torch.bool, device=d)
                miller, final_exp = launches(libs[who], pts, lines, is_add,
                                             f, ok, stream)
                miller()
                final_exp()
                torch.cuda.synchronize()
                if not np.array_equal(ok.cpu().numpy(), expect[:n]):
                    raise AssertionError(f"{who} ({other_dir}): verdicts "
                                         "differ from the construction")
                words[who] = f.clone()
                m_ms = chip_smoke.device_ms(torch, miller, reps=REPS)
                e_ms = chip_smoke.device_ms(torch, final_exp, reps=REPS)
                row[f"{who}_{turn}"] = {"miller_ms": m_ms,
                                        "final_exp_ms": e_ms,
                                        "check_ms": m_ms + e_ms}
                print(f"{other_dir} n={n} {who}: miller {m_ms:.3f} ms, "
                      f"final_exp {e_ms:.3f} ms, check {m_ms + e_ms:.3f} ms",
                      flush=True)
            if not torch.equal(words["this"], words["other"]):
                raise AssertionError(f"Miller words differ from {other_dir}")
            results.append(row)
    print(json.dumps({"device": smi, "pairing_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
