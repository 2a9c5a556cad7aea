"""The idemix pairing kernels' per-lane code (fabric_mod_tpu_torch/csrc/
fp256bn_pairing.cu and its fp256bn_field.cuh) built by the host C++
compiler, for the CPU tests.

Outside `__CUDACC__` the sources are plain C++: the field and tower
operations, `schedule_to_mont`, `miller_lane` and `final_exp_lane`
compile with g++, so the kernels' arithmetic is tested on a machine with
no card.  `fp_ops` runs one Fp operation over n values, `tower_ops` one
tower operation over n Fp12-sized records, `miller` and `final_exp` the
kernels' lanes over the kernels' own word planes, one lane after another
(a lane's thread group runs every rank's part in turn, its exchange
slots a host array), and `products` reads (and clears) the count of Fp
products."""
import ctypes
import shutil
import subprocess

import numpy as np

from fabric_mod_tpu_torch.ops import _build

SRC = _build.source_path("fp256bn_pairing")

# fp_ops' operations
FP_MUL, FP_SQR, FP_ADD, FP_SUB, FP_INV, FP_TO_MONT, FP_FROM_MONT, FP_NEG = range(8)
# tower_ops' operations, over records of 96 words (an Fp12: coefficient
# c = 6h + 2i + j at words 8c .. 8c + 7; an Fp2 or Fp6 takes the first 16
# or 48 words).  F12_MUL_LINE takes yp, A, Bxp from y's words 0-7, 8-23
# and 24-39.
(F2_MUL, F2_SQR, F2_INV, F6_MUL, F6_MUL_SPARSE12, F6_INV, F12_MUL, F12_SQR,
 F12_MUL_LINE, F12_FROBENIUS, F12_INV) = range(11)

_SHIM = r"""
#include <vector>
#include "{src}"

static Fp rec_fp(const uint32_t* w) {{
  Fp x;
  for (int k = 0; k < 8; ++k) x.v[k] = w[k];
  return x;
}}
static Fp2 rec_f2(const uint32_t* w) {{ return Fp2{{{{rec_fp(w), rec_fp(w + 8)}}}}; }}
static Fp6 rec_f6(const uint32_t* w) {{
  return Fp6{{{{rec_f2(w), rec_f2(w + 16), rec_f2(w + 32)}}}};
}}
static Fp12 rec_f12(const uint32_t* w) {{ return Fp12{{{{rec_f6(w), rec_f6(w + 48)}}}}; }}
static void put_fp(uint32_t* w, const Fp& x) {{
  for (int k = 0; k < 8; ++k) w[k] = x.v[k];
}}
static void put_f2(uint32_t* w, const Fp2& x) {{ put_fp(w, x.c[0]); put_fp(w + 8, x.c[1]); }}
static void put_f6(uint32_t* w, const Fp6& x) {{
  for (int i = 0; i < 3; ++i) put_f2(w + 16 * i, x.c[i]);
}}
static void put_f12(uint32_t* w, const Fp12& x) {{ put_f6(w, x.c[0]); put_f6(w + 48, x.c[1]); }}
// a lane's thread group on the host: every rank in turn, slots here
static uint32_t xch_words[kXchWords];
static Group host_group() {{ return Group{{0, xch_words, 1, 0}}; }}

extern "C" void fp_ops(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {{
  for (int i = 0; i < n; ++i) {{
    const Fp x = rec_fp(a + 8 * i), y = rec_fp(b + 8 * i);
    Fp r;
    switch (op) {{
      case 0: r = fp_mul(x, y); break;
      case 1: r = fp_sqr(x); break;
      case 2: r = fp_add(x, y); break;
      case 3: r = fp_sub(x, y); break;
      case 4: r = fp_inv(x); break;
      case 5: r = fp_to_mont(x); break;
      case 6: r = fp_from_mont(x); break;
      default: r = fp_neg(x); break;
    }}
    put_fp(out + 8 * i, r);
  }}
}}

extern "C" void tower_ops(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {{
  for (int i = 0; i < n; ++i) {{
    const uint32_t* x = a + 96 * i;
    const uint32_t* y = b + 96 * i;
    uint32_t* o = out + 96 * i;
    Group g = host_group();
    switch (op) {{
      case 0: put_f2(o, f2_mul(rec_f2(x), rec_f2(y))); break;
      case 1: put_f2(o, f2_sqr(rec_f2(x))); break;
      case 2: put_f2(o, f2_inv(rec_f2(x))); break;
      case 3: put_f6(o, f6_mul(rec_f6(x), rec_f6(y))); break;
      case 4: put_f6(o, f6_mul_sparse12(rec_f6(x), rec_f2(y), rec_f2(y + 16))); break;
      case 5: put_f6(o, f6_inv(rec_f6(x))); break;
      case 6: put_f12(o, f12_mul(g, rec_f12(x), rec_f12(y))); break;
      case 7: put_f12(o, f12_sqr(g, rec_f12(x))); break;
      case 8: put_f12(o, f12_mul_line(g, rec_f12(x), rec_fp(y), rec_f2(y + 8),
                                      rec_f2(y + 24)));
              break;
      case 9: put_f12(o, f12_frobenius(rec_f12(x))); break;
      default: put_f12(o, f12_inv(rec_f12(x))); break;
    }}
  }}
}}

extern "C" void miller(const uint32_t* pts, const uint32_t* lines, const int32_t* is_add,
                       int n_main, uint32_t* out, int n, int n_sched) {{
  std::vector<Fp> lines_m((n_main + 2) * kLineValues);
  for (int s = 0; s < n_sched; ++s) {{
    schedule_to_mont(lines + (size_t)s * (n_main + 2) * kStepWords, n_main + 2,
                     lines_m.data(), 0, 1);
    for (int lane = 0; lane < n; ++lane) {{
      Group g = host_group();
      miller_lane(g, lane, n, pts + (size_t)s * 16 * n, lines_m.data(), is_add, n_main,
                  out + (size_t)s * kF12Words * n);
    }}
  }}
}}

extern "C" void final_exp(const uint32_t* f, int check, uint8_t* ok, uint32_t* out, int n) {{
  for (int lane = 0; lane < n; ++lane) {{
    Group g = host_group();
    final_exp_lane(g, lane, n, check != 0, f, ok, out);
  }}
}}

extern "C" unsigned long long products() {{
  const unsigned long long c = fp_products;
  fp_products = 0;
  return c;
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
    lib.tower_ops.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int]
    lib.miller.argtypes = [P, P, P, ctypes.c_int, P, ctypes.c_int,
                           ctypes.c_int]
    lib.final_exp.argtypes = [P, ctypes.c_int, P, P, ctypes.c_int]
    for f in (lib.fp_ops, lib.tower_ops, lib.miller, lib.final_exp):
        f.restype = None
    lib.products.argtypes = []
    lib.products.restype = ctypes.c_ulonglong
    return lib


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


def tower_ops(lib, op: int, x: np.ndarray, y: np.ndarray = None) -> np.ndarray:
    """One tower operation over (n, 96) uint32 records: (n, 96) out."""
    x = np.ascontiguousarray(x, np.uint32)
    y = x if y is None else np.ascontiguousarray(y, np.uint32)
    out = np.zeros_like(x)
    lib.tower_ops(op, x.ctypes.data, y.ctypes.data, out.ctypes.data, len(x))
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
