"""The idemix pairing kernels' per-lane code (fabric_mod_tpu_torch/csrc/
fp256bn_pairing.cu and its headers) built by the host C++ compiler, for
the CPU tests.

Outside `__CUDACC__` the sources are plain C++: the field, the linear
forms, the program interpreter, `miller_lane` and `final_exp_lane`
compile with g++, so the kernels' arithmetic is tested on a machine with
no card.  `fp_ops` runs one Fp operation over n values, `program_ops`
one tower program over n Fp12-sized records, `miller` and `final_exp`
the kernels' lanes over the kernels' own word planes, one lane after
another (a lane's group runs every rank's part of a stage in turn, its
shared memory a host array), and `counts` reads (and clears) the Fp
products (squares among them), inverses and product rounds run."""
import ctypes
import shutil
import subprocess

import numpy as np

from fabric_mod_tpu_torch.ops import _build
from fabric_mod_tpu_torch.ops import fp256bn_programs as programs

SRC = _build.source_path("fp256bn_pairing")

# fp_ops' operations (add, sub and neg through the linear-form accumulator)
FP_MUL, FP_SQR, FP_ADD, FP_SUB, FP_INV, FP_TO_MONT, FP_FROM_MONT, FP_NEG = range(8)

_SHIM = r"""
#include <vector>
#include "{src}"

extern "C" void fp_ops(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {{
  for (int i = 0; i < n; ++i) {{
    Fp x, y, r;
    for (int k = 0; k < 8; ++k) {{ x.v[k] = a[8 * i + k]; y.v[k] = b[8 * i + k]; }}
    Acc acc = acc_zero();
    switch (op) {{
      case 0: r = fp_mul(x, y); break;
      case 1: r = fp_sqr(x); break;
      case 2: acc_add(acc, x, 0u); acc_add(acc, y, 0u); r = acc_reduce(acc); break;
      case 3: acc_add(acc, x, 0u); acc_add(acc, y, ~0u); r = acc_reduce(acc); break;
      case 4: r = fp_inv(x); break;
      case 5: r = fp_mul(x, fp_load_const(kBnR2)); break;
      case 6: {{ Fp one = fp_zero(); one.v[0] = 1u; r = fp_mul(x, one); break; }}
      default: acc_add(acc, x, ~0u); r = acc_reduce(acc); break;
    }}
    for (int k = 0; k < 8; ++k) out[8 * i + k] = r.v[k];
  }}
}}

// One program over n records: its output (at x's slots when inplace),
// inputs x, y, z, w, each 96 words a record
extern "C" void program_ops(int prog, int inplace, const uint32_t* x, const uint32_t* y,
                            const uint32_t* z, const uint32_t* w, uint32_t* out, int n) {{
  const uint32_t area = kBlockHeadWords, d = area + kArgWords + kBnMaxTemps * 8,
                 xs = d + 96, ys = xs + 96, zs = ys + 96, ws = zs + 96;
  std::vector<uint32_t> sm(ws + 96);
  block_head(sm.data(), 0, 1);
  const Lane ln = make_lane(sm.data(), 0, area);
  for (int i = 0; i < n; ++i) {{
    for (int k = 0; k < 96; ++k) {{
      sm[xs + k] = x[96 * i + k];
      sm[ys + k] = y[96 * i + k];
      sm[zs + k] = z[96 * i + k];
      sm[ws + k] = w[96 * i + k];
      sm[d + k] = 0u;
    }}
    const uint32_t dst = inplace ? xs : d;
    run(ln, prog, dst, xs, ys, zs, ws);
    for (int k = 0; k < 96; ++k) out[96 * i + k] = sm[dst + k];
  }}
}}

extern "C" void miller(const uint32_t* pts, const uint32_t* lines, const int32_t* is_add,
                       int n_main, uint32_t* out, int n, int n_sched) {{
  const MillerLayout L(n_main + 2);
  std::vector<uint32_t> sm(L.bytes(1) / 4);
  block_head(sm.data(), 0, 1);
  for (int s = 0; s < n_sched; ++s) {{
    const uint32_t* sched = lines + (size_t)s * (n_main + 2) * kStepWords;
    schedule_a_to_mont(sm.data(), L, sched, n_main + 2, 0, 1);
    for (int lane = 0; lane < n; ++lane) {{
      const Lane ln = make_lane(sm.data(), 0, L.lane(0));
      miller_lane(ln, L, L.lane(0), lane, n, pts + (size_t)s * 16 * n, sched, is_add, n_main,
                  out + (size_t)s * kF12Words * n);
    }}
  }}
}}

extern "C" void final_exp(const uint32_t* f, int check, uint8_t* ok, uint32_t* out, int n) {{
  std::vector<uint32_t> sm(kBlockHeadWords + kFinalLaneWords);
  block_head(sm.data(), 0, 1);
  for (int lane = 0; lane < n; ++lane) {{
    const Lane ln = make_lane(sm.data(), 0, kBlockHeadWords);
    final_exp_lane(ln, kBlockHeadWords, lane, n, check != 0, f, ok, out);
  }}
}}

// Fp products, Fp inverses, product rounds and Fp squares (of the
// products) since the last call
extern "C" void counts(unsigned long long* c) {{
  c[0] = fp_products;
  c[1] = fp_inverses;
  c[2] = bn_rounds;
  c[3] = fp_squares;
  fp_products = fp_inverses = bn_rounds = fp_squares = 0;
}}
"""


def build(directory):
    """The shim as a ctypes library built in `directory`, or None when
    the host has no C++ compiler."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    shim = directory / "fp256bn_shim.cpp"
    shim.write_text(_SHIM.format(src=SRC))
    lib_path = directory / "libfp256bn_shim.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-x", "c++", "-o", str(lib_path),
                    str(shim)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.fp_ops.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int]
    lib.program_ops.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, P, P,
                                ctypes.c_int]
    lib.miller.argtypes = [P, P, P, ctypes.c_int, P, ctypes.c_int,
                           ctypes.c_int]
    lib.final_exp.argtypes = [P, ctypes.c_int, P, P, ctypes.c_int]
    lib.counts.argtypes = [P]
    for f in (lib.fp_ops, lib.program_ops, lib.miller, lib.final_exp,
              lib.counts):
        f.restype = None
    return lib


def counts(lib) -> dict:
    """{products, squares, inverses, rounds} run since the last call (the
    squares are among the products)."""
    c = np.zeros(4, np.uint64)
    lib.counts(c.ctypes.data)
    return {"products": int(c[0]), "squares": int(c[3]),
            "inverses": int(c[1]), "rounds": int(c[2])}


def words(values) -> np.ndarray:
    """Python ints (< 2^256) -> (len, 8) uint32 little-endian words."""
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                     for v in values], np.uint32).reshape(-1, 8)


def ints(w: np.ndarray) -> list:
    """(..., 8) uint32 words -> Python ints, in C order."""
    flat = np.asarray(w, np.uint32).reshape(-1, 8)
    return [sum(int(x) << (32 * k) for k, x in enumerate(row)) for row in flat]


def fp_ops(lib, op: int, a, b=None) -> list:
    """One Fp operation over the ints a (and b): the result ints."""
    a = np.ascontiguousarray(words(a))
    b = a if b is None else np.ascontiguousarray(words(b))
    out = np.zeros_like(a)
    lib.fp_ops(op, a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a))
    return ints(out)


def program_ops(lib, name: str, x: np.ndarray, y=None, z=None, w=None,
                inplace: bool = False) -> np.ndarray:
    """One tower program over (n, 96) uint32 records, 96 words an
    argument (an Fp12: coefficient c = 6h + 2i + j at words 8c .. 8c + 7;
    an Fp or Fp2 argument takes the first 8 or 16 words): (n, 96) out."""
    x = np.ascontiguousarray(x, np.uint32)
    args = [x] + [x if v is None else np.ascontiguousarray(v, np.uint32)
                  for v in (y, z, w)]
    out = np.zeros_like(x)
    lib.program_ops(programs.PROGRAM_ORDER.index(name), int(inplace),
                    *(a.ctypes.data for a in args), out.ctypes.data, len(x))
    return out


def miller(lib, pts: np.ndarray, lines: np.ndarray, is_add: np.ndarray):
    """The Miller lanes on the kernel's planes: pts (S, 2, 8, n) and
    lines (S, n_main + 2, 4, 8) uint32, is_add (n_main,) -> (S, 12, 8, n)
    uint32."""
    pts = np.ascontiguousarray(pts, np.uint32)
    lines = np.ascontiguousarray(lines, np.uint32)
    flags = np.ascontiguousarray(is_add, np.int32)
    S, n = pts.shape[0], pts.shape[-1]
    out = np.zeros((S, 12, 8, n), np.uint32)
    lib.miller(pts.ctypes.data, lines.ctypes.data, flags.ctypes.data,
               len(flags), out.ctypes.data, n, S)
    return out


def final_exp(lib, f: np.ndarray, check: bool):
    """The final exponentiation's lanes on (S, 12, 8, n) planes: the (n,)
    bool verdicts (check) or the (12, 8, n) uint32 planes (pairing)."""
    f = np.ascontiguousarray(f, np.uint32)
    n = f.shape[-1]
    ok = np.zeros(n, np.uint8)
    out = np.zeros((12, 8, n), np.uint32)
    lib.final_exp(f.ctypes.data, int(check), ok.ctypes.data, out.ctypes.data,
                  n)
    return ok.astype(bool) if check else out
