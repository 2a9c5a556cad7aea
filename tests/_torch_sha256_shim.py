"""The SHA-256 kernel's per-lane code (fabric_mod_tpu_torch/csrc/sha256.cu)
built by the host C++ compiler, for the CPU tests.

Outside `__CUDACC__` the source is plain C++: the producer's
`sha256_schedule_block` (a block's words to its 64 K_t + W_t) and the
consumer's `sha256_rounds` (two threads a lane, here both run in
lockstep and their shuffle a swap) compile with g++, and so do
`lane_blocks`, `ring_offset`, `pair_zero_column` and `write_e`.
`sha256_e` here composes them as the kernel does: the lanes in thread
blocks of kLanes, each block's ring of kRingDepth slots laid out by
`ring_offset` (poisoned first), the producer's side driven by a host
loop as far ahead of the rounds as the ring lets the kernel's producer
run, and every lane looping to its block's longest lane.  So the
kernel's arithmetic, its ring indexing, its block loop and its
write-back are tested on a machine with no card."""
import ctypes
import shutil
import subprocess

import numpy as np

from fabric_mod_tpu_torch.ops import _build

SRC = _build.source_path("sha256")

_SHIM = r"""
#include <vector>
#include "{src}"

extern "C" int ring_depth() {{ return kRingDepth; }}
extern "C" int lanes_per_block() {{ return kLanes; }}

// the shuffle of a pair, for both of its threads run in lockstep here
struct SwapXchg {{
  void operator()(const uint32_t (&send)[2], uint32_t (&recv)[2]) const {{
    recv[0] = send[1];
    recv[1] = send[0];
  }}
}};

extern "C" void sha256_e(const uint32_t* words, const int32_t* nblocks,
                         int max_blocks, uint32_t* packed, int n) {{
  constexpr int qs = 4 * kCols;
  std::vector<uint32_t> ring(ring_words(kCols));
  for (int base = 0; base < n; base += kLanes) {{
    for (auto& w : ring) w = 0xA5A5A5A5u;
    for (int t = 0; t < kLanes; ++t)
      pair_zero_column(ring.data() + ring_offset(0, 2 * t + 1, kCols), qs);
    int own[kLanes], nmax = 0;
    uint32_t s[kLanes][8];
    for (int t = 0; t < kLanes; ++t) {{
      const int lane = base + t;
      own[t] = lane < n ? lane_blocks(lane, n, nblocks, max_blocks, packed)
                        : -1;
      if (own[t] > nmax) nmax = own[t];
      init_state(s[t]);
    }}
    // block j goes into slot j % kRingDepth once block j - kRingDepth is
    // consumed: the producer runs that far ahead of the rounds
    int made = 0;
    for (int j = 0; j < nmax; ++j) {{
      for (; made < nmax && made < j + kRingDepth; ++made)
        for (int t = 0; t < kLanes; ++t)
          if (made < own[t])
            sha256_schedule_block(
                words + ((std::size_t)(base + t) * max_blocks + made) * 16,
                ring.data() + ring_offset(made % kRingDepth, 2 * t, kCols),
                qs);
      const int slot = j % kRingDepth;
      // the pair of lane t: every lane runs every block, as on the card
      for (int t = 0; t < kLanes; ++t) {{
        uint32_t w[2][4];
        for (int k = 0; k < 4; ++k) {{
          w[0][k] = s[t][4 + k];
          w[1][k] = s[t][k];
        }}
        const uint32_t* const kw[2] = {{
            ring.data() + ring_offset(slot, 2 * t, kCols),
            ring.data() + ring_offset(slot, 2 * t + 1, kCols)}};
        const int roles[2] = {{0, 1}};
        const bool live[2] = {{j < own[t], j < own[t]}};
        sha256_rounds<2>(w, kw, qs, roles, live, 1u, SwapXchg());
        for (int k = 0; k < 4; ++k) {{
          s[t][4 + k] = w[0][k];
          s[t][k] = w[1][k];
        }}
      }}
    }}
    for (int t = 0; t < kLanes; ++t)
      if (own[t] >= 0) write_e(s[t], base + t, n, packed);
  }}
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
    for fn in (lib.ring_depth, lib.lanes_per_block):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


def sha256_e(lib, words: np.ndarray, nblocks: np.ndarray,
             packed: np.ndarray) -> np.ndarray:
    """The lanes on (n, max_blocks, 16) uint32 words, (n,) int32 block
    counts and a (ROWS, n) int32 buffer, in the kernel's thread blocks:
    a copy of the buffer with the raw lanes' e rows written."""
    words = np.ascontiguousarray(words, np.uint32)
    nblocks = np.ascontiguousarray(nblocks, np.int32)
    out = np.ascontiguousarray(packed, np.int32).copy()
    lib.sha256_e(words.ctypes.data, nblocks.ctypes.data, words.shape[1],
                 out.ctypes.data, out.shape[1])
    return out
