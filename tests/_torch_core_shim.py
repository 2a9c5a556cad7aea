"""The verify core's per-lane CUDA code (fabric_mod_tpu_torch/csrc/
p256_core.cu) built by the host C++ compiler, for the CPU tests.

Outside `__CUDACC__` the source is plain C++: `prologue_group` (a
lane's thread group, its ranks run in turn), `epilogue_lane` and the
arithmetic mod n compile with g++, so the kernels' arithmetic is tested
on a machine with no card.  `fn_ops` op 0 is the product mod n, op 1
the inverse in the Montgomery domain, op 2 the plain divstep inverse.  `run_core`
drives the whole core as the card does: the prologue lanes, the plain
ladder on their window planes (ops/p256_cuda.ladder_words on the CPU),
the epilogue lanes."""
import ctypes
import shutil
import subprocess

import numpy as np
import torch

from fabric_mod_tpu_torch.ops import _build, p256_core, p256_cuda

SRC = _build.source_path("p256_core")

_SHIM = r"""
#include "{src}"
extern "C" void fn_ops(int op, const uint32_t* a, const uint32_t* b,
                       uint32_t* out, int n) {{
  for (int i = 0; i < n; ++i) {{
    Fe x, y;
    for (int k = 0; k < 8; ++k) {{ x.v[k] = a[8 * i + k]; y.v[k] = b[8 * i + k]; }}
    const Fe r = op == 0 ? fn_mul(x, y) : op == 1 ? fn_inv(x) : fn_inv_plain(x);
    for (int k = 0; k < 8; ++k) out[8 * i + k] = r.v[k];
  }}
}}
extern "C" void prologue(const uint32_t* e, const uint32_t* packed,
                         int32_t* u1w, int32_t* u2w, uint8_t* key_ok, int n) {{
  for (int lane = 0; lane < n; ++lane) {{
    Fe slot;
    prologue_group(0, true, lane, n, e, packed, u1w, u2w, key_ok, &slot);
  }}
}}
extern "C" void epilogue(const uint32_t* X, const uint32_t* Z,
                         const uint32_t* packed, const uint8_t* key_ok,
                         uint8_t* ok, int n) {{
  for (int lane = 0; lane < n; ++lane)
    epilogue_lane(lane, n, X, Z, packed, key_ok, ok);
}}
"""


def build(directory):
    """The shim as a ctypes library built in `directory`, or None when
    the host has no C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    shim = directory / "core_shim.cpp"
    shim.write_text(_SHIM.format(src=SRC))
    lib_path = directory / "libcore_shim.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-x", "c++", "-o", str(lib_path),
                    str(shim)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.fn_ops.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int]
    lib.prologue.argtypes = [P] * 5 + [ctypes.c_int]
    lib.epilogue.argtypes = [P] * 5 + [ctypes.c_int]
    for f in (lib.fn_ops, lib.prologue, lib.epilogue):
        f.restype = None
    return lib


def prologue(lib, e: np.ndarray, packed: np.ndarray):
    """The prologue lanes on (8, n) e words and the (ROWS, n) buffer
    (int32 numpy): (u1_w, u2_w, key_ok) as CPU tensors."""
    n = packed.shape[1]
    e, packed = np.ascontiguousarray(e), np.ascontiguousarray(packed)
    u1 = np.zeros((64, n), np.int32)
    u2 = np.zeros((64, n), np.int32)
    key_ok = np.zeros(n, np.uint8)
    lib.prologue(e.ctypes.data, packed.ctypes.data, u1.ctypes.data,
                 u2.ctypes.data, key_ok.ctypes.data, n)
    return (torch.from_numpy(u1), torch.from_numpy(u2),
            torch.from_numpy(key_ok.astype(bool)))


def epilogue(lib, X, Z, packed: np.ndarray, key_ok) -> torch.Tensor:
    """The epilogue lanes: (n,) bool verdicts as a CPU tensor."""
    n = packed.shape[1]
    X = np.ascontiguousarray(np.asarray(X, np.int32))
    Z = np.ascontiguousarray(np.asarray(Z, np.int32))
    packed = np.ascontiguousarray(packed)
    k = np.ascontiguousarray(np.asarray(key_ok, bool).astype(np.uint8))
    ok = np.zeros(n, np.uint8)
    lib.epilogue(X.ctypes.data, Z.ctypes.data, packed.ctypes.data,
                 k.ctypes.data, ok.ctypes.data, n)
    return torch.from_numpy(ok.astype(bool))


def run_core(lib, packed: np.ndarray, mixed: bool = False):
    """The whole core on the host: prologue lanes, the plain ladder on
    their planes, epilogue lanes.  (verdicts, (u1_w, u2_w, key_ok),
    (X, Z)) with X, Z the ladder's (8, n) int32 words."""
    buf = torch.from_numpy(packed)
    pro = prologue(lib, packed[p256_core.ROW_E:p256_core.ROW_E + 8], packed)
    X, _Y, Z = p256_cuda.ladder_words(
        pro[0], pro[1], p256_core.rows(buf, p256_core.ROW_QX),
        p256_core.rows(buf, p256_core.ROW_QY), mixed)
    return epilogue(lib, X.numpy(), Z.numpy(), packed, pro[2]), pro, (X, Z)
