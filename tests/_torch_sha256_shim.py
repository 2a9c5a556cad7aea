"""The SHA-256 kernel's per-lane code (fabric_mod_tpu_torch/csrc/sha256.cu)
built by the host C++ compiler, for the CPU tests.

Outside `__CUDACC__` the source is plain C++: `sha256_e_lane` (one
lane's blocks into the packed buffer's e rows) compiles with g++, so the
kernel's arithmetic, its block loop and its write-back are tested on a
machine with no card.  `sha256_e` runs every lane in turn, as the
kernel's threads do."""
import ctypes
import shutil
import subprocess

import numpy as np

from fabric_mod_tpu_torch.ops import _build

SRC = _build.source_path("sha256")

_SHIM = r"""
#include "{src}"
extern "C" void sha256_e(const uint32_t* words, const int32_t* nblocks,
                         int max_blocks, uint32_t* packed, int n) {{
  for (int lane = 0; lane < n; ++lane)
    sha256_e_lane(lane, n, words, nblocks, max_blocks, packed);
}}
"""


def build(directory):
    """The shim as a ctypes library built in `directory`, or None when
    the host has no C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    shim = directory / "sha256_shim.cpp"
    shim.write_text(_SHIM.format(src=SRC))
    lib_path = directory / "libsha256_shim.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-x", "c++", "-o", str(lib_path),
                    str(shim)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.sha256_e.argtypes = [P, P, ctypes.c_int, P, ctypes.c_int]
    lib.sha256_e.restype = None
    return lib


def sha256_e(lib, words: np.ndarray, nblocks: np.ndarray,
             packed: np.ndarray) -> np.ndarray:
    """The lanes on (n, max_blocks, 16) uint32 words, (n,) int32 block
    counts and a (ROWS, n) int32 buffer: a copy of the buffer with the
    raw lanes' e rows written."""
    words = np.ascontiguousarray(words, np.uint32)
    nblocks = np.ascontiguousarray(nblocks, np.int32)
    out = np.ascontiguousarray(packed, np.int32).copy()
    lib.sha256_e(words.ctypes.data, nblocks.ctypes.data, words.shape[1],
                 out.ctypes.data, out.shape[1])
    return out
