"""The CUDA ladder kernels (fabric_mod_tpu_torch/csrc/p256_ladder.cu), the
verify core's prologue and epilogue kernels (csrc/p256_core.cu; their
host-compiled lanes are tests/test_torch_cuda_core.py), the raw lanes'
SHA-256 kernel (csrc/sha256.cu; host-compiled in
tests/test_torch_sha256_kernel.py), the idemix pairing check's two
kernels (csrc/fp256bn_pairing.cu; host-compiled in
tests/test_torch_fp256bn_kernel.py) and the other
device paths of the port on the card (the policy evaluator, a
block commit, the batched FP256BN pairing, the e2e network).

Tests marked `cuda` need a card and skip without one; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The others run anywhere: the source's constants against values computed
here, and — since the kernels' field and point arithmetic is plain C++
outside `__CUDACC__` (the inline PTX has a C++ twin) — that arithmetic
compiled by the host C++ compiler, its field operations held against
Python ints and its per-lane ladders bit-equal to the plain PyTorch
ladders."""
import ctypes
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_mod_tpu_torch.ops import _build, limbs9, p256, p256_core, p256_cuda
from fabric_mod_tpu_torch.utils import fixtures

SRC = _build.source_path("p256_ladder")
R256 = 1 << 256
R270 = 1 << 270


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain limb code is many small ops: one intra-op thread a
    worker keeps the tier-1 workers from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ladder_case(n, seed=7):
    """Random windows, distinct keys (i+2)G, edge lanes 0-2 and invalid
    keys in the last two lanes: (u1, u2, qx_m, qy_m) CPU tensors."""
    rng = random.Random(seed)
    g = (p256.GX, p256.GY)
    pts, acc = [], p256._affine_add(g, g)
    for _ in range(n):
        pts.append(acc)
        acc = p256._affine_add(acc, g)
    xs = [x for x, _ in pts]
    ys = [y for _, y in pts]
    ys[-2] ^= 1                                  # off-curve key
    xs[-1], ys[-1] = 0, 0                        # key (0, 0)
    u1 = np.array([[rng.randrange(16) for _ in range(n)]
                   for _ in range(p256.N_WINDOWS)], np.int32)
    u2 = np.array([[rng.randrange(16) for _ in range(n)]
                   for _ in range(p256.N_WINDOWS)], np.int32)
    u1[:, 0] = 0
    u2[:, 0] = 0                                 # lane 0 stays at infinity
    u2[:, 1] = 0                                 # lane 1: G adds only
    u1[1:, 2] = 0                                # lane 2: one MSB window
    qx = limbs9.to_device(np.stack([limbs9.int_to_limbs(x * R270 % p256.P)
                                    for x in xs]), "cpu")
    qy = limbs9.to_device(np.stack([limbs9.int_to_limbs(y * R270 % p256.P)
                                    for y in ys]), "cpu")
    return torch.from_numpy(u1), torch.from_numpy(u2), qx, qy


def _plain_words(mixed, u1, u2, qx, qy):
    """The plain ladder's canonical non-Montgomery X, Y, Z as int64 words."""
    fp = p256._consts()[0]
    plain = p256.shamir_ladder_mixed if mixed else p256.shamir_ladder
    return [limbs9.limbs_to_words(limbs9.canonical(limbs9.from_mont(c, fp), fp))
            for c in plain(u1, u2, qx, qy)]


def _words(v):
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]


def test_source_constants():
    text = SRC.read_text() + (_build.CSRC / "p256_field.cuh").read_text()

    def array(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", text).group(1)
        return [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    P = p256.P
    assert array("kP") == _words(P)
    assert array("kR2") == _words(R256 * R256 % P)
    assert array("kOneM") == _words(R256 % P)
    assert array("kC3") == _words(3 * R256 % P)
    assert array("kC3B") == _words(3 * p256.B * R256 % P)
    # the rows of constant second operands, each c * R mod p for the c
    # its comment names (b is the curve's b)
    body = re.search(r"kRoundConsts\[kConstRows\]\[8\] = \{(.*?)\n\};", text,
                     re.S).group(1)
    rows = re.findall(r"\{([^}]*)\},\s*//\s*(\w+)", body)
    assert len(rows) == 18
    for words, name in rows:
        c = int(name[:-1]) * p256.B if name.endswith("b") else int(name)
        got = [int(x.strip().rstrip("u"), 16) for x in words.split(",")]
        assert got == _words(c * R256 % P), name
    # the reduction's closed form: q = -p^-1 mod 2^256 = 1 + 2^96 + 2^193 - 2^224
    assert (-pow(P, -1, R256)) % R256 == (1 + (1 << 96) + (1 << 193) - (1 << 224)) % R256
    # the verify core's constants (csrc/p256_core.cu): mod n (n in 30-bit
    # limbs and n^-1 mod 2^30 for the divstep inversion), b in Montgomery
    # form mod p, n0' = -n^-1 mod 2^32, the buffer's layout
    core = _build.source_path("p256_core").read_text()

    def core_array(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", core).group(1)
        return [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    N = p256.N
    assert core_array("kN") == _words(N)
    assert core_array("kR2N") == _words(R256 * R256 % N)
    assert core_array("kR3N") == _words(pow(R256, 3, N))
    body = re.search(r"kN30\[9\] = \{([^}]*)\}", core).group(1)
    assert [int(x.strip(), 16) for x in body.split(",")] == [
        (N >> (30 * i)) & (2**30 - 1) for i in range(9)]
    inv30 = int(re.search(r"kNInv30 = (0x[0-9A-Fa-f]+)u;", core).group(1), 16)
    assert inv30 * N % (1 << 30) == 1
    assert core_array("kBM") == _words(p256.B * R256 % P)
    n0 = int(re.search(r"kN0Inv = (0x[0-9A-Fa-f]+)u;", core).group(1), 16)
    assert n0 == (-pow(N, -1, 1 << 32)) % (1 << 32)
    assert (n0 * N) % (1 << 32) == (1 << 32) - 1
    layout = dict(re.findall(r"(kRow\w+|kRows|kFlag\w+) = (\d+)u?", core))
    assert {k: int(v) for k, v in layout.items()} == {
        "kRowE": p256_core.ROW_E, "kRowR": p256_core.ROW_R,
        "kRowS": p256_core.ROW_S, "kRowQx": p256_core.ROW_QX,
        "kRowQy": p256_core.ROW_QY, "kRowFlags": p256_core.ROW_FLAGS,
        "kRows": p256_core.ROWS, "kFlagRangeOk": p256_core.FLAG_RANGE_OK,
        "kFlagPreOk": p256_core.FLAG_PRE_OK,
        "kFlagRnLtP": p256_core.FLAG_RN_LT_P}


@pytest.mark.parametrize("mixed", [False, True])
def test_g_table_words(mixed):
    tab = p256_cuda.g_table_words(mixed).astype(np.int64) & 0xFFFFFFFF
    rows = tab.reshape(tab.shape[0], tab.shape[1], 8)

    def val(w):
        return sum(int(x) << (32 * k) for k, x in enumerate(w))
    mults = p256.g_multiples()
    start = 0 if mixed else 1
    if not mixed:
        assert val(rows[0][0]) == 0 and val(rows[0][2]) == 0
    for k, (x, y) in enumerate(mults):
        row = rows[start + k]
        assert val(row[0]) == x * R256 % p256.P
        assert val(row[1]) == y * R256 % p256.P


# The host shim: the kernels' per-lane code and field arithmetic, built
# by g++ (no __CUDACC__: the PTX's plain C++ twin, every rank of a group
# played in turn by one call).
_HOST_SHIM = r"""
#include "{src}"
#include <vector>
extern "C" void lanes(int mixed, const int32_t* u1, const int32_t* u2,
                      const uint32_t* qx, const uint32_t* qy, const uint32_t* g,
                      uint32_t* X, uint32_t* Y, uint32_t* Z, int n, int live) {{
  std::vector<uint32_t> area(kLaneWordsMixed);
  for (int lane = 0; lane < n; ++lane) {{
    Lane ln = make_lane(area.data(), 0, &kRoundConsts[0][0]);
    if (mixed) ladder_mixed_lane(ln, lane, live, n, u1, u2, qx, qy, g, X, Y, Z);
    else ladder_projective_lane(ln, lane, live, n, u1, u2, qx, qy, g, X, Y, Z);
  }}
}}
extern "C" void field(int op, const uint32_t* a, const uint32_t* b,
                      uint32_t* out, int n) {{
  for (int i = 0; i < n; ++i) {{
    Fe x, y;
    for (int k = 0; k < 8; ++k) {{ x.v[k] = a[8 * i + k]; y.v[k] = b[8 * i + k]; }}
    const Fe r = op == 0 ? fe_mul(x, y) : op == 1 ? fe_sqr(x)
               : op == 2 ? fe_add(x, y) : fe_sub(x, y);
    for (int k = 0; k < 8; ++k) out[8 * i + k] = r.v[k];
  }}
}}
"""

FIELD_OPS = ("mul", "sqr", "add", "sub")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_shim")
    shim = d / "shim.cpp"
    shim.write_text(_HOST_SHIM.format(src=SRC))
    lib_path = d / "libshim.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-x", "c++", "-o", str(lib_path),
                    str(shim)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.lanes.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                          + [ctypes.c_int, ctypes.c_int])
    lib.lanes.restype = None
    lib.field.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.field.restype = None
    return lib


def _field_cases(seed=11, n_random=200):
    """(a, b) operand pairs: every pair of the edge operands (a may be
    any 256-bit value for the product, b < p), then random ones."""
    P = p256.P
    edges_b = [0, 1, 2, P - 1, P - 2, R256 % P, (1 << 255) % P]
    edges_a = edges_b + [R256 - 1, R256 - 2, P, P + 1]
    rng = random.Random(seed)
    pairs = [(a, b) for a in edges_a for b in edges_b]
    pairs += [(rng.randrange(P), rng.randrange(P)) for _ in range(n_random)]
    pairs += [(rng.randrange(R256), rng.randrange(P)) for _ in range(n_random)]
    return pairs


def _field_want(op, a, b):
    P = p256.P
    rinv = pow(R256, -1, P)
    if op == "mul":
        return a * b * rinv % P
    if op == "sqr":
        return a * a * rinv % P
    if op == "add":
        return (a + b) % P
    return (a - b) % P


def _as_words(vals):
    return np.array([_words(v) for v in vals], np.uint32).reshape(-1)


@pytest.mark.parametrize("op", FIELD_OPS)
def test_field_ops_on_host_compiler(host_lib, op):
    """fe_mul, fe_sqr, fe_add and fe_sub (the P-256 special-form
    reduction, the dedicated square, the masked corrections) against
    Python ints on edge and random operands, within their input
    contracts: a < 2^256 for the product's first operand, every other
    operand < p."""
    pairs = _field_cases()
    if op != "mul":                 # squares, sums, differences: a < p
        pairs = [(a, b) for a, b in pairs if a < p256.P]
    a = _as_words([x for x, _ in pairs])
    b = _as_words([y for _, y in pairs])
    out = np.zeros_like(a)
    host_lib.field(FIELD_OPS.index(op), a.ctypes.data, b.ctypes.data,
                   out.ctypes.data, len(pairs))
    got = out.reshape(-1, 8).astype(object)
    for i, (x, y) in enumerate(pairs):
        val = sum(int(w) << (32 * k) for k, w in enumerate(got[i]))
        assert val == _field_want(op, x, y), (op, hex(x), hex(y))


def test_kernel_arithmetic_on_host_compiler(host_lib):
    """The kernels' per-lane code (ladder_*_lane, the round schedule
    played rank by rank) built by g++ for the host gives the plain
    ladders' exact canonical outputs, at a width that is a multiple of
    neither the group nor the block; a lane past the edge stores
    nothing."""
    n = 13
    u1, u2, qx, qy = _ladder_case(n)
    qxw = p256_cuda.mont_limbs_to_words(qx).numpy().copy()
    qyw = p256_cuda.mont_limbs_to_words(qy).numpy().copy()
    u1n, u2n = u1.numpy().copy(), u2.numpy().copy()
    for mixed in (False, True):
        g = np.ascontiguousarray(p256_cuda.g_table_words(mixed))
        out = [np.zeros((8, n), np.int32) for _ in range(3)]
        host_lib.lanes(int(mixed), u1n.ctypes.data, u2n.ctypes.data,
                       qxw.ctypes.data, qyw.ctypes.data, g.ctypes.data,
                       *(o.ctypes.data for o in out), n, 1)
        want = _plain_words(mixed, u1, u2, qx, qy)
        for o, w, coord in zip(out, want, "XYZ"):
            got = p256_cuda.from_u32_bits(torch.from_numpy(o))
            assert torch.equal(got, w), (mixed, coord)
        dead = [np.full((8, 1), 7, np.int32) for _ in range(3)]
        host_lib.lanes(int(mixed), u1n[:, :1].copy().ctypes.data,
                       u2n[:, :1].copy().ctypes.data,
                       qxw[:, :1].copy().ctypes.data,
                       qyw[:, :1].copy().ctypes.data, g.ctypes.data,
                       *(o.ctypes.data for o in dead), 1, 0)
        assert all((o == 7).all() for o in dead), mixed


_CARD_SHIM = r"""
#include "{src}"
__global__ void field_kernel(int op, const uint32_t* a, const uint32_t* b,
                             uint32_t* out, int n) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x, y;
  for (int k = 0; k < 8; ++k) {{ x.v[k] = a[8 * i + k]; y.v[k] = b[8 * i + k]; }}
  const Fe r = op == 0 ? fe_mul(x, y) : op == 1 ? fe_sqr(x)
             : op == 2 ? fe_add(x, y) : fe_sub(x, y);
  for (int k = 0; k < 8; ++k) out[8 * i + k] = r.v[k];
}}
extern "C" int field(int op, const void* a, const void* b, void* out, int n) {{
  field_kernel<<<(n + 127) / 128, 128>>>(
      op, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaDeviceSynchronize());
}}
"""


def test_library_path_keys_the_whole_build_command(monkeypatch):
    """A built library's name hashes every flag of its nvcc command, not
    only the target: adding any flag names another library, so a stale
    one is never loaded."""
    base = {n: _build.library_path(n) for n in _build.SOURCES}
    flags = _build._flags()
    monkeypatch.setattr(_build, "_flags", lambda: [*flags, "-lineinfo"])
    other = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(other[n] != base[n] for n in _build.SOURCES)
    monkeypatch.undo()
    assert {n: _build.library_path(n) for n in _build.SOURCES} == base
    assert flags[:len(_build.ARCH_FLAGS)] == list(_build.ARCH_FLAGS)


@pytest.mark.cuda
def test_field_ops_on_card(cuda_device, tmp_path):
    """The inline-PTX field arithmetic, built by nvcc for the card,
    against Python ints on the same edge and random operands as the
    host test."""
    shim = tmp_path / "field.cu"
    shim.write_text(_CARD_SHIM.format(src=SRC))
    lib_path = tmp_path / "libfield.so"
    subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(shim)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(lib_path))
    lib.field.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.field.restype = ctypes.c_int
    for op in FIELD_OPS:
        pairs = _field_cases()
        if op != "mul":
            pairs = [(a, b) for a, b in pairs if a < p256.P]
        a = torch.from_numpy(_as_words([x for x, _ in pairs]).view(np.int32))
        b = torch.from_numpy(_as_words([y for _, y in pairs]).view(np.int32))
        a, b = a.to(cuda_device), b.to(cuda_device)
        out = torch.zeros_like(a)
        assert lib.field(FIELD_OPS.index(op), a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), len(pairs)) == 0
        got = out.cpu().numpy().view(np.uint32).reshape(-1, 8).astype(object)
        for i, (x, y) in enumerate(pairs):
            val = sum(int(w) << (32 * k) for k, w in enumerate(got[i]))
            assert val == _field_want(op, x, y), (op, hex(x), hex(y))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 5])
@pytest.mark.parametrize("mixed", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, mixed, n):
    """At a ragged width (a multiple of neither the group nor the
    block) and at a width smaller than one block, with edge and invalid
    lanes: the kernel's canonical X, Y, Z are bit-equal to the plain
    ladder's on the card, and its launch count rises by one."""
    u1, u2, qx, qy = (t.to(cuda_device) for t in _ladder_case(n))
    name = p256_cuda.KERNELS[mixed]
    before = p256_cuda.counts()[name]
    X, Y, Z = p256_cuda.kernel_words(
        u1.contiguous(), u2.contiguous(),
        p256_cuda.mont_limbs_to_words(qx).contiguous(),
        p256_cuda.mont_limbs_to_words(qy).contiguous(), mixed)
    torch.cuda.synchronize()
    assert p256_cuda.counts()[name] == before + 1
    want = _plain_words(mixed, u1, u2, qx, qy)
    for got, w in zip((X, Y, Z), want):
        assert torch.equal(p256_cuda.from_u32_bits(got), w)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    u1, u2, qx, qy = (t.to(cuda_device) for t in _ladder_case(4))
    qx_w = p256_cuda.mont_limbs_to_words(qx)
    with pytest.raises(ValueError):
        p256_cuda.kernel_words(u1.to(torch.int64), u2, qx_w, qx_w, False)
    with pytest.raises(ValueError):
        p256_cuda.kernel_words(u1, u2, qx_w[:, :3], qx_w, False)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 13])
def test_core_kernels_match_plain_on_card(cuda_device, n):
    """The verify core's prologue and epilogue kernels (csrc/p256_core.cu)
    on the card, with every edge lane of fixtures.make_core_lanes: the
    window planes and key_ok are bit-equal to the plain prologue's on
    the card, the verdicts over the ladder's output equal the plain
    epilogue's and the construction's, and each launch count rises by
    one."""
    planes, pre_ok, expect = fixtures.make_core_lanes(n)
    _, range_ok, rn_lt_p = p256.range_checks(*planes)
    buf = torch.from_numpy(p256_core.pack(planes, range_ok, pre_ok,
                                          rn_lt_p)).to(cuda_device)
    e = p256_core.rows(buf, p256_core.ROW_E)
    before = p256_core.counts()
    u1, u2, key_ok = p256_core.prologue(e, buf)
    want = p256_core.prologue_plain(e, buf)
    for got, w in zip((u1, u2, key_ok), want):
        assert torch.equal(got, w)
    X, _Y, Z = p256_cuda.kernel_words(
        u1, u2, p256_core.rows(buf, p256_core.ROW_QX),
        p256_core.rows(buf, p256_core.ROW_QY), False)
    ok = p256_core.epilogue(X, Z, buf, key_ok)
    torch.cuda.synchronize()
    assert ok.device.type == "cuda"
    assert ok.tolist() == p256_core.epilogue_plain(X, Z, buf, key_ok).tolist() \
        == expect.tolist()
    after = p256_core.counts()
    assert {k: after[k] - before[k] for k in after} == {
        "verify_prologue": 1, "verify_epilogue": 1}


@pytest.mark.cuda
def test_core_kernels_reject_bad_inputs(cuda_device):
    planes, pre_ok, _ = fixtures.make_core_lanes(16)
    _, range_ok, rn_lt_p = p256.range_checks(*planes)
    buf = torch.from_numpy(p256_core.pack(planes, range_ok, pre_ok,
                                          rn_lt_p)).to(cuda_device)
    e = p256_core.rows(buf, p256_core.ROW_E)
    with pytest.raises(ValueError):
        p256_core.prologue(e.to(torch.int64), buf)
    with pytest.raises(ValueError):
        p256_core.prologue(e[:, :3], buf)
    u1, u2, key_ok = p256_core.prologue(e, buf)
    with pytest.raises(ValueError):
        p256_core.epilogue(e, e, buf, key_ok.to(torch.uint8))


@pytest.mark.cuda
def test_digest_verify_call_is_three_launches(cuda_device):
    """A digest-only GpuVerifier call runs the prologue, one ladder and
    the epilogue once each, and no plain limb op: the device's kernel
    count is that of those three and the final gather and copies."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from torch.profiler import ProfilerActivity, profile
    items, expect = fixtures.make_block(2, n_tx=8)
    v = gpu.GpuVerifier(cache_size=0)
    assert v.verify_many(items).tolist() == expect.tolist()      # warm
    p256_core.reset_counts()
    p256_cuda.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = v.verify_many(items)
        torch.cuda.synchronize()
    assert got.tolist() == expect.tolist()
    assert p256_core.counts() == {"verify_prologue": 1, "verify_epilogue": 1}
    assert p256_cuda.counts() == {"ladder_projective": 1, "ladder_mixed": 0}
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) <= 6, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 5, 1, 16, 4096])
def test_sha256_kernel_matches_plain_on_card(cuda_device, n):
    """sha256_e on the card writes the plain SHA-256's e words (and
    hashlib's digests) into the raw lanes' e rows, and nothing else."""
    import hashlib

    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.bccsp import der
    from fabric_mod_tpu_torch.ops import sha256
    rng = random.Random(n)
    msgs = [rng.randbytes(k) for k in (0, 1, 55, 56, 63, 64, 119, 120)]
    msgs = (msgs + [rng.randbytes(rng.randrange(3000))
                    for _ in range(n)])[:n]
    words, nblocks, _ok = der.pack_messages(msgs)
    # zero blocks past every lane's own, as the reference's rounded plane
    words = np.concatenate(
        [words, np.zeros((n, 64 - words.shape[1], 16), np.uint32)], 1)
    base = np.random.default_rng(n).integers(
        -2**31, 2**31, (p256_core.ROWS, n)).astype(np.int32)
    has_msg = np.arange(n) % 7 != 3
    base[p256_core.ROW_FLAGS] = np.where(has_msg, p256_core.FLAG_HAS_MSG, 0)
    w = _device.upload(words.view(np.int32), cuda_device)
    nb = _device.upload(nblocks, cuda_device)
    got = torch.from_numpy(base).to(cuda_device)
    before = sha256.counts()["sha256_e"]
    sha256.sha256_e(w, nb, got)
    want = sha256.sha256_e_plain(w, nb, torch.from_numpy(base).to(
        cuda_device))
    torch.cuda.synchronize()
    assert sha256.counts()["sha256_e"] == before + 1
    assert torch.equal(got, want)
    e = got[:8].cpu().numpy().view(np.uint32)
    for lane in range(n):
        if has_msg[lane]:
            value = sum(int(x) << (32 * k) for k, x in enumerate(e[:, lane]))
            assert value.to_bytes(32, "big") == \
                hashlib.sha256(msgs[lane]).digest()
        else:
            assert got[:, lane].cpu().numpy().tolist() == \
                base[:, lane].tolist()


@pytest.mark.cuda
def test_sha256_kernel_long_lane_and_clamped_nblocks_on_card(cuda_device):
    """One 48-block lane among short and message-free lanes, two lanes
    whose nblocks lie out of range: the wrapper's launch (one count)
    writes the plain version's e rows, bit for bit."""
    from fabric_mod_tpu_torch import device as _device
    from fabric_mod_tpu_torch.bccsp import der
    from fabric_mod_tpu_torch.ops import sha256
    n = 64
    rng = random.Random(48)
    msgs = [rng.randbytes(rng.randrange(200)) for _ in range(n)]
    msgs[7] = rng.randbytes(3000)
    words, nblocks, _ok = der.pack_messages(msgs)
    assert words.shape[1] == 48 and nblocks[7] == 48
    nblocks[3], nblocks[11] = -2, 48 + 9
    base = np.random.default_rng(48).integers(
        -2**31, 2**31, (p256_core.ROWS, n)).astype(np.int32)
    # every fifth lane from lane 4 without a message; lanes 3, 7, 11 raw
    base[p256_core.ROW_FLAGS] = np.where(np.arange(n) % 5 != 4,
                                         p256_core.FLAG_HAS_MSG, 0)
    w = _device.upload(words.view(np.int32), cuda_device)
    nb = _device.upload(nblocks, cuda_device)
    want = sha256.sha256_e_plain(w, nb, torch.from_numpy(base).to(
        cuda_device))
    got = torch.from_numpy(base).to(cuda_device)
    before = sha256.counts()["sha256_e"]
    sha256.sha256_e(w, nb, got)
    torch.cuda.synchronize()
    assert sha256.counts()["sha256_e"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_raw_verify_call_is_four_launches(cuda_device):
    """A GpuVerifier call with raw-message lanes runs the SHA-256 kernel,
    the prologue, one ladder and the epilogue once each, and no torch
    SHA-256 op."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ops import sha256
    from torch.profiler import ProfilerActivity, profile
    items, expect = fixtures.make_block(3, n_tx=8, raw_endorsers=True)
    v = gpu.GpuVerifier(cache_size=0)
    assert v.verify_many(items).tolist() == expect.tolist()      # warm
    p256_core.reset_counts()
    p256_cuda.reset_counts()
    sha256.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = v.verify_many(items)
        torch.cuda.synchronize()
    assert got.tolist() == expect.tolist()
    assert sha256.counts() == {"sha256_e": 1}
    assert p256_core.counts() == {"verify_prologue": 1, "verify_epilogue": 1}
    assert p256_cuda.counts() == {"ladder_projective": 1, "ladder_mixed": 0}
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(kernels) <= 7, kernels


@pytest.mark.cuda
def test_raw_block_commits_on_card(cuda_device):
    """A raw-message world's 16-tx blocks commit on the card through the
    SHA-256 kernel and the vectorized MVCC: flags equal the fixture's."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ops import sha256
    from fabric_mod_tpu_torch.protos import messages as m
    world = fixtures.make_commit_world(raw_messages=True)
    blocks, expected = fixtures.make_commit_blocks(world, 2, 16)
    committer = world.committer(gpu.GpuVerifier(cache_size=0),
                                tensor_policy=True)
    before = sha256.counts()["sha256_e"]
    for raw, want in zip(blocks, expected):
        assert committer.store_block(m.Block.decode(raw)) == want
    assert sha256.counts()["sha256_e"] >= before + len(blocks)


@pytest.mark.cuda
def test_gpu_verifier_on_card(cuda_device):
    from fabric_mod_tpu_torch.bccsp import gpu
    items, expect = fixtures.make_block(1, n_tx=40, raw_endorsers=True)
    for ladder in gpu.LADDERS:
        name = p256_cuda.KERNELS[ladder == "mixed"]
        before = p256_cuda.counts()[name]
        core_before = sum(p256_core.counts().values())
        got = gpu.GpuVerifier(ladder=ladder, cache_size=0).verify_many(items)
        assert got.tolist() == expect.tolist()
        assert p256_cuda.counts()[name] > before
        assert sum(p256_core.counts().values()) > core_before


@pytest.mark.cuda
def test_policy_evaluator_on_card_equals_cpu(cuda_device):
    """The tensor-policy evaluator over a CUDA mask (the fused seam's
    form) gives the CPU pass's verdicts, at the caps' widths."""
    from fabric_mod_tpu_torch.policy import tensorpolicy as tp
    rng = np.random.default_rng(3)
    n, n_i, n_p, n_t = 500, tp.MAX_IDENTS, tp.MAX_PRINCIPALS, 9
    ops = rng.integers(0, 7, (n, n_t)).astype(np.int32)
    args = rng.integers(0, n_p, (n, n_t)).astype(np.int32)
    valid = rng.random((n, n_i)) < 0.7
    sat = rng.random((n, n_i, n_p)) < 0.5
    want = tp.eval_numpy(valid, sat, ops, args)
    got = tp.eval_torch(*(torch.from_numpy(a).to(cuda_device)
                          for a in (valid, sat, ops, args)))
    assert got.device.type == "cuda"
    assert got.cpu().numpy().tolist() == want.tolist()


@pytest.mark.cuda
def test_block_commits_on_card(cuda_device):
    """A 16-tx block of every planted kind commits through the port's
    Committer on the card: flags equal the fixture's, the evaluator took
    the CUDA mask, and the ladder kernel ran."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.policy import tensorpolicy as tp
    from fabric_mod_tpu_torch.protos import messages as m
    world = fixtures.make_commit_world()
    blocks, expected = fixtures.make_commit_blocks(world, 2, 16)
    committer = world.committer(gpu.GpuVerifier(cache_size=0),
                                tensor_policy=True)
    tp.reset_counts()
    before = p256_cuda.counts()["ladder_projective"]
    for raw, want in zip(blocks, expected):
        assert committer.store_block(m.Block.decode(raw)) == want
    assert tp.counts() == {"cuda": len(blocks)}
    assert p256_cuda.counts()["ladder_projective"] > before


@pytest.mark.cuda
def test_private_block_commits_into_durable_ledger_on_card(cuda_device,
                                                           tmp_path):
    """A collection definition and a 20-tx block with private writes
    commit through the port's Committer on the card (tensor policy) into
    a durable ledger with durable transient and pvt stores: every flag
    VALID, the plaintext applied, incremental fingerprint == full scan,
    a reopen replays nothing to the same fingerprint, and the verify
    core launched."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.ledger.pvtdata import (PvtDataStore,
                                                     TransientStore)
    from fabric_mod_tpu_torch.protos import messages as m
    world = fixtures.make_commit_world()
    blocks, plain, keys = fixtures.make_pvt_blocks(world, 1, 20)
    d = str(tmp_path / "ledger")
    led = KvLedger(world.channel_id, d)
    transient = TransientStore(dir_path=str(tmp_path / "transient"))
    led.attach_pvt(transient, PvtDataStore(dir_path=str(tmp_path / "pvt")),
                   lambda ns, coll: 2)
    for txid, pvt in plain.items():
        transient.persist(txid, 0, pvt)
    committer = world.committer(gpu.GpuVerifier(cache_size=0),
                                tensor_policy=True, ledger=led)
    before = p256_core.counts()["verify_prologue"]
    for raw in blocks:
        flags = committer.store_block(m.Block.decode(raw))
        assert set(flags) == {m.TxValidationCode.VALID}
    qe = led.new_query_executor()
    for key, value in keys.values():
        assert qe.get_private_data(fixtures.NAMESPACE,
                                   fixtures.PVT_COLLECTION, key) == value
    fp = led.state_fingerprint()
    assert fp == led.state_fingerprint_full()
    led.close()
    again = KvLedger(world.channel_id, d)
    assert again.replayed_blocks == 0 and again.state_fingerprint() == fp
    again.close()
    assert p256_core.counts()["verify_prologue"] > before


@pytest.mark.cuda
def test_pairing_check_on_card_equals_cpu(cuda_device):
    """The batched FP256BN pairing check on the card gives the CPU plain
    run's verdicts on 8 lanes (two of them tampered), as a CUDA tensor."""
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    world = fixtures.make_idemix_world(seed=3, n_users=1)
    a, abar, expect = fixtures.make_pairing_lanes(world, 8, tamper_every=4)
    ik = world.issuer.key
    args = (a, ik.W, [p.neg() for p in abar], ik.g2)
    got = dev.pairing_check_batch(*args, lazy=True)
    assert got.device.type == "cuda"
    want = dev.pairing_check_batch(*args, device="cpu")
    assert got.cpu().numpy().tolist() == want.tolist() == expect.tolist()


@pytest.mark.cuda
def test_pairing_on_card_equals_host(cuda_device):
    """f12_to_host of a card pairing_batch equals the host pairing."""
    from fabric_mod_tpu_torch.idemix import fp256bn as host
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    g2 = host.g2_generator()
    q = host.g2_mul(0x5EED, g2)
    pts = [host.g1_mul(k, host.G1.generator()) for k in (3, 0xC0FFEE)]
    got = dev.pairing_batch(pts, q)
    assert got.device.type == "cuda"
    for i, p in enumerate(pts):
        assert dev.f12_to_host(got, i) == host.pairing(p, q)


@pytest.mark.cuda
def test_pairing_kernels_equal_plain_on_card(cuda_device):
    """The check's two kernels (csrc/fp256bn_pairing.cu) against the plain
    version on the card over 8 lanes, two tampered: the same CUDA mask;
    each kernel against its own plain version on the same inputs."""
    from fabric_mod_tpu_torch.ops import fp256bn_cuda as cuda
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    world = fixtures.make_idemix_world(seed=4, n_users=1)
    a, abar, expect = fixtures.make_pairing_lanes(world, 8, tamper_every=4)
    ik = world.issuer.key
    neg = [p.neg() for p in abar]
    got = dev.pairing_check_batch(a, ik.W, neg, ik.g2, lazy=True)
    want = dev.pairing_check_plain(a, ik.W, neg, ik.g2, lazy=True)
    assert got.device.type == want.device.type == "cuda"
    assert torch.equal(got, want)
    assert got.cpu().numpy().tolist() == expect.tolist()
    s1, s2 = dev.line_schedule(ik.W), dev.line_schedule(ik.g2)
    pts = torch.as_tensor(np.stack([cuda.point_words(a),
                                    cuda.point_words(neg)]), device="cuda")
    lines = torch.as_tensor(np.stack([s1.line_words(), s2.line_words()]),
                            device="cuda")
    is_add = torch.as_tensor(s1.is_add.astype(np.int32), device="cuda")
    f = cuda.miller(pts, lines, is_add)
    assert torch.equal(f, cuda.miller_plain(pts, lines, is_add))
    assert torch.equal(cuda.final_exp(f, check=True),
                       cuda.final_exp_plain(f, check=True))
    pair = cuda.final_exp(f[:1].contiguous(), check=False)
    assert torch.equal(pair, cuda.final_exp_plain(f[:1], check=False))


@pytest.mark.cuda
def test_pairing_kernels_launch_counts(cuda_device):
    """A check and a pairing_batch are one Miller and one final
    exponentiation launch each; an empty batch launches nothing; a
    pairing through the kernels equals the host's."""
    from fabric_mod_tpu_torch.idemix import fp256bn as host
    from fabric_mod_tpu_torch.ops import fp256bn_cuda as cuda
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    g2 = host.g2_generator()
    q = host.g2_mul(0xBEEF, g2)
    pts = [host.g1_mul(k, host.G1.generator()) for k in (5, 0xFACADE)]
    cuda.reset_counts()
    ok = dev.pairing_check_batch(pts, q, [p.neg() for p in pts], q)
    assert ok.tolist() == [True, True]
    assert cuda.counts() == {"fp256bn_miller": 1, "fp256bn_final_exp": 1}
    got = dev.pairing_batch(pts, q)
    assert cuda.counts() == {"fp256bn_miller": 2, "fp256bn_final_exp": 2}
    for i, p in enumerate(pts):
        assert dev.f12_to_host(got, i) == host.pairing(p, q)
    cuda.reset_counts()
    empty = dev.pairing_check_batch([], q, [], g2, lazy=True)
    assert empty.device.type == "cuda" and empty.numel() == 0
    assert cuda.counts() == {"fp256bn_miller": 0, "fp256bn_final_exp": 0}


@pytest.mark.cuda
def test_e2e_network_on_card(cuda_device, tmp_path):
    """Two 8-tx blocks of every planted kind through the port's e2e
    Network on the card: ordered, MCS-verified and committed with the
    construction's flags, the tampered creator rejected at ingress, the
    evaluator on the CUDA mask of both blocks and the ladder launched."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.orderer import BroadcastError
    from fabric_mod_tpu_torch.policy import tensorpolicy as tp
    from fabric_mod_tpu_torch.protos import protoutil
    material = fixtures.make_network_material(
        5, max_message_count=8, batch_timeout="60s")
    net = e2e.Network(str(tmp_path), material=material,
                      verifier=gpu.GpuVerifier(cache_size=0),
                      tensor_policy=True)
    try:
        submits, expected = fixtures.make_e2e_stream(net, 16, plant_every=8)
        tp.reset_counts()
        before = p256_cuda.counts()["ladder_projective"]
        def feed():
            for env, ok in submits:
                if ok:
                    net.broadcast.submit(env)
                else:
                    with pytest.raises(BroadcastError):
                        net.broadcast.submit(env)
        assert e2e.commit_until(net, 16, 300, feed=feed)[1] == 16
        assert net.ledger.height == 3
        for b in (1, 2):
            block = net.ledger.get_block_by_number(b)
            assert list(protoutil.block_txflags(block)) == \
                expected[8 * (b - 1):8 * b]
        assert tp.counts() == {"cuda": 2}
        # one MCS verify and one validator bucket per block at least
        assert p256_cuda.counts()["ladder_projective"] >= before + 4
    finally:
        net.close()


@pytest.mark.cuda
def test_deployed_chaincode_block_commits_on_card(cuda_device, tmp_path):
    """cc2 deployed by the lifecycle ceremony (AND(Org1, Org3)) on a
    Network over the card's default GpuVerifier (its verdict cache on,
    the Writers check batched through it, so the validator's creator
    lanes hit the cache), then one block of cc2 invokes (every 4th
    endorsed by a MAJORITY that cc2's policy refuses): the flags equal a
    host-verifier Channel's on the same blocks, the evaluator ran on the
    CUDA mask and the ladder launched."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import sw
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.policy import from_string
    from fabric_mod_tpu_torch.policy import tensorpolicy as tp
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    material = fixtures.make_network_material(
        14, max_message_count=16, batch_timeout="300ms")
    net = e2e.Network(str(tmp_path / "net"), material=material,
                      tensor_policy=True, ingress_batching=True)
    cid, config = config_from_block(m.Block.decode(material.genesis))
    led = KvLedger(cid, str(tmp_path / "host"))
    host = Channel(cid, led, sw.SwVerifier(), Bundle(cid, config, sw.SwCSP()),
                   sw.SwCSP())
    try:
        host.init_from_genesis(m.Block.decode(material.genesis))
        pol = m.ApplicationPolicy(signature_policy=from_string(
            "AND('Org1.peer', 'Org3.peer')")).encode()
        assert net.deploy_chaincode("cc2", "1.0", 1, policy=pol) == 3
        world = fixtures.network_world(material)
        envs = fixtures.make_put_txs(world, [
            ("cc2", f"k{i}", b"v", ("Org1", "Org2") if i % 4 == 3
             else ("Org1", "Org3")) for i in range(16)], b"cuda-cc2")
        tp.reset_counts()
        before = p256_cuda.counts()["ladder_projective"]
        e2e.submit_all(net, envs)
        assert net.pump_committed(19, timeout=120) == 19
        assert tp.counts() == {"cuda": 1}
        assert p256_cuda.counts()["ladder_projective"] >= before + 2
        assert net.verifier.cache.hits > 0
        for n in range(1, net.ledger.height):
            block = net.ledger.get_block_by_number(n)
            assert host.store_block(m.Block.decode(block.encode())) == \
                list(protoutil.block_txflags(block))
        tip = net.ledger.get_block_by_number(net.ledger.height - 1)
        assert list(protoutil.block_txflags(tip)) == [
            m.TxValidationCode.ENDORSEMENT_POLICY_FAILURE if i % 4 == 3
            else m.TxValidationCode.VALID for i in range(16)]
        assert net.ledger.state_fingerprint() == led.state_fingerprint()
    finally:
        net.close()
        host.close()
        led.close()


@pytest.mark.cuda
def test_raft_e2e_network_on_card(cuda_device, tmp_path):
    """Two 8-tx blocks through three Raft orderers on the card, submitted
    through a follower with the Writers check batched on the card (each
    orderer its own ingress service): the construction's flags, the
    same chain on every orderer, and the verify core launched for the
    MCS, the validator and ingress."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.protos import protoutil
    material = fixtures.make_network_material(
        6, consensus_type="etcdraft", orderers=3, max_message_count=8,
        batch_timeout="60s")
    net = e2e.Network(str(tmp_path), material=material,
                      verifier=gpu.GpuVerifier(cache_size=0),
                      tensor_policy=True, ingress_batching=True,
                      election_timeout=(5.0, 10.0), heartbeat_s=0.5)
    try:
        follower = next(o for o in net.orderers
                        if o.id != net.raft_leader())
        submits, expected = fixtures.make_e2e_stream(net, 16, plant_every=8)
        before = dict(p256_core.counts())

        def feed():
            for env, ok in submits:
                if ok:
                    follower.broadcast.submit(env)
        assert e2e.commit_until(net, 16, 300, feed=feed)[1] == 16
        got = [f for b in (1, 2) for f in protoutil.block_txflags(
            net.ledger.get_block_by_number(b))]
        assert got == expected
        stores = [o.support.store for o in net.orderers]
        for b in (1, 2):
            assert len({protoutil.block_header_hash(
                s.get_block_by_number(b).header) for s in stores}) == 1
        # ingress (18 checks), 2 MCS checks and 2 validator calls
        after = p256_core.counts()
        assert all(after[k] >= before[k] + 5 for k in after)
    finally:
        net.close()


@pytest.mark.cuda
def test_gossip_peers_share_one_card(cuda_device, tmp_path):
    """One 8-tx block pushed into 4 gossip peers whose channels share one
    BatchingVerifyService over one GpuVerifier on the card (envelope
    checks, MCS checks and block commits), and a copy with a flipped
    orderer-signature byte pushed after it: every peer commits the block
    with the flags and fingerprint the same peers get on the host
    verifier, no peer takes the copy, and the verify core launched."""
    from tests._torch_gossip_world import PortPeer, seed_membership
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.gossip import InProcNetwork
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    material = fixtures.make_network_material(
        7, max_message_count=8, batch_timeout="60s", gossip_peers=4)
    net = e2e.Network(str(tmp_path / "net"), material=material,
                      verifier=sw.SwVerifier())
    try:
        submits, expected = fixtures.make_e2e_stream(net, 8, plant_every=8)
        for env, ok in submits:
            if ok:
                net.broadcast.submit(env)
        assert e2e.commit_until(net, 8, 300)[1] == 8
        raw = net.support.store.get_block_by_number(1).encode()
    finally:
        net.close()
    outcomes = []
    for arm, verifier in (("host", sw.SwVerifier()),
                          ("card", gpu.BatchingVerifyService(
                              gpu.GpuVerifier(cache_size=0)))):
        fabric = InProcNetwork()
        peers = [PortPeer(str(tmp_path / arm), i, material.genesis, pems,
                          fabric, verifier, tensor_policy=True,
                          pipeline_depth=2)
                 for i, pems in enumerate(material.gossip_peers)]
        before = dict(p256_core.counts())
        try:
            seed_membership([p.node for p in peers], m)
            leader = peers[0].node
            assert leader.state.add_block(m.Block.decode(raw))
            assert leader.state.drain() == 1
            assert leader.state.flush(300)
            leader.gossip_block(m.Block.decode(raw))
            evil = m.Block.decode(fixtures.tamper_block_signature(raw))
            evil.header.number = 2
            leader.gossip_block(evil)
            for p in peers:
                p.node.state.drain()
                assert p.node.state.flush(300)
            outcomes.append((
                [p.ledger.height for p in peers],
                [list(protoutil.block_txflags(p.ledger.get_block_by_number(1)))
                 for p in peers],
                {p.ledger.state_fingerprint() for p in peers},
                [p.node.state.errors for p in peers]))
        finally:
            for p in peers:
                p.close()
            if arm == "card":
                verifier.close()
        if arm == "card":
            after = p256_core.counts()
            assert all(after[k] > before[k] for k in after), (before, after)
    assert outcomes[0] == outcomes[1]
    heights, flags, fps, errors = outcomes[1]
    assert heights == [2] * 4 and flags == [expected] * 4
    assert len(fps) == 1 and errors == [[]] * 4


@pytest.mark.cuda
def test_relay_tree_over_one_card(cuda_device, tmp_path):
    """Two 8-tx blocks relayed down an 8-peer dissemination tree (degree
    2, depth 3) whose channels share one BatchingVerifyService over one
    GpuVerifier on the card (tensor policy, a commit pipe of depth 2):
    one orderer stream, every non-leader gets both frames through the
    tree, each byte-identical to a direct pull's, one state fingerprint
    equal to the direct-pull peer's, no error kept, and the verify core
    launched."""
    import threading
    import time
    from tests._torch_relay_world import RelayWorld
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu, sw
    from fabric_mod_tpu_torch.orderer import DeliverService
    from fabric_mod_tpu_torch.peer.fanout import encode_frame
    material = fixtures.make_network_material(
        8, max_message_count=8, batch_timeout="60s", gossip_peers=8)
    net = e2e.Network(str(tmp_path / "net"), material=material,
                      verifier=sw.SwVerifier())
    service = gpu.BatchingVerifyService(gpu.GpuVerifier(cache_size=0))
    world = None
    try:
        submits, _ = fixtures.make_e2e_stream(net, 16, plant_every=8)
        world = RelayWorld(str(tmp_path), material,
                           lambda: DeliverService(net.support),
                           [service] * 8, degree=2, tensor_policy=True,
                           pipeline_depth=2)
        world.start()
        before = dict(p256_core.counts())
        for env, ok in submits:
            if ok:
                net.broadcast.submit(env)
        deadline = time.monotonic() + 300
        while min(world.heights()) < 3 and time.monotonic() < deadline:
            assert world.errors() == []
            time.sleep(0.01)
        assert world.heights() == [3] * 8 and world.errors() == []
        assert len(world.streams) == 1
        client = net.deliver_client()
        t = threading.Thread(target=client.run, daemon=True)
        t.start()
        while net.ledger.height < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        client.stop()
        t.join(timeout=60)
        for i, tap in enumerate(world.taps):
            got = dict(tap)
            assert set(got) == (set() if i == world.lead else {1, 2})
            for num, frame in got.items():
                assert frame == encode_frame(
                    net.channel_id, "full",
                    net.ledger.get_block_by_number(num))
        assert {p.ledger.state_fingerprint() for p in world.peers} == \
            {net.ledger.state_fingerprint()}
        after = p256_core.counts()
        assert all(after[k] > before[k] for k in after)
    finally:
        if world is not None:
            world.close()
        service.close()
        net.close()


@pytest.mark.cuda
def test_two_slice_router_commits_on_one_card(cuda_device):
    """Two channels on a 2-slice ChannelShardRouter whose slices are
    unmeshed GpuVerifiers on the one card (tensor policy, depth-2 pipes),
    blocks submitted round robin: per channel the flags and fingerprint
    equal an independent run on one GpuVerifier, the flags carry both
    outcomes, a rider through the shared service gets the construction's
    verdicts, and the verify core launched."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    from fabric_mod_tpu_torch.peer.commitpipe import ValidatorCommitTarget
    from fabric_mod_tpu_torch.peer.txvalidator import (
        TxValidator, ValidationInfoProvider)
    from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
    from fabric_mod_tpu_torch.protos import messages as m
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.sharding import ChannelShardRouter
    world = fixtures.make_commit_world()

    def target(cid, verifier):
        led = KvLedger(cid)
        return ValidatorCommitTarget(TxValidator(
            cid, world.mgr, ApplicationPolicyEvaluator(world.mgr), verifier,
            ValidationInfoProvider(world.policy),
            tx_id_exists=led.tx_id_exists, tensor_policy=True), led)
    streams = {cid: fixtures.make_channel_stream(world.signers, cid, 2, 24)
               for cid in ("c0", "c1")}
    base = fixtures.independent_baseline(
        streams, lambda cid: target(cid, gpu.GpuVerifier(cache_size=0)))
    router = ChannelShardRouter(n_slices=2, verifier_factory=(
        lambda i, mesh: gpu.GpuVerifier(cache_size=0)))
    targets = {}
    before = dict(p256_core.counts())
    try:
        for cid in streams:
            targets[cid] = target(cid, router.add_channel(cid))
            router.bind_target(cid, targets[cid])
        for n in range(2):
            for cid, raws in streams.items():
                router.submit_block(cid, m.Block.decode(raws[n]))
        items, expect = fixtures.make_verify_items(8, invalid_every=3)
        assert router.service.verify_many_for("c1", items) == expect
        assert router.flush(timeout_s=300)
    finally:
        router.close()
    kinds = set()
    for cid, t in targets.items():
        flags = [list(protoutil.block_txflags(t.ledger.get_block_by_number(n)))
                 for n in range(2)]
        assert (flags, t.ledger.state_fingerprint()) == base[cid][:2]
        kinds |= {f for blk in flags for f in blk}
    assert kinds == {m.TxValidationCode.VALID,
                     m.TxValidationCode.ENDORSEMENT_POLICY_FAILURE}
    after = p256_core.counts()
    assert all(after[k] > before[k] for k in after)


@pytest.mark.cuda
def test_mesh_verifier_over_two_cards_equals_one_card(cuda_device):
    """GpuVerifier(mesh=data_mesh()) over every card, and each verifier of
    slice_meshes(2), give a one-card GpuVerifier's verdicts on 2048 lanes
    with planted adversarial and raw-message lanes; the fused lane's
    tensor lies on the mesh's first card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.parallel import data_mesh, slice_meshes
    items, expect = fixtures.make_block(2, n_tx=683, raw_endorsers=True)
    items, expect = items[:2048], expect[:2048]
    want = gpu.GpuVerifier(cache_size=0).verify_many(items)
    assert want.tolist() == expect.tolist()
    n = torch.cuda.device_count()
    meshes = [data_mesh()] + (slice_meshes(2) if n % 2 == 0 else [])
    for mesh in meshes:
        v = gpu.GpuVerifier(mesh=mesh, cache_size=0)
        assert v.verify_many(items).tolist() == want.tolist()
        fused = v.verify_many_fused_async(items)()
        assert fused.device == mesh[0]
        assert fused.cpu().tolist() == want.tolist()


@pytest.mark.cuda
def test_device_lens_trace_holds_every_launch_on_card(cuda_device, tmp_path):
    """The device lens around one GpuVerifier dispatch of 64 lanes, the
    endorser lanes raw: its Chrome trace holds one event for each of the
    four hand-written kernels the window launched, and the window is
    one-shot."""
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.observability import tracing
    items, expect = fixtures.make_block(0, n_tx=20, raw_endorsers=True)
    verifier = gpu.GpuVerifier(cache_size=0, profile_dir=str(tmp_path))
    verifier.verify_many(items[:8])
    tracing.rearm_device_profile()
    try:
        with tracing.active():
            assert (verifier.verify_many(items) == expect).all()
            lens = tracing.last_lens()
            assert (verifier.verify_many(items) == expect).all()
            assert tracing.last_lens() is lens     # one-shot
    finally:
        tracing.rearm_device_profile()
    assert lens.kernel_table() == {
        "ladder_projective": (1, 1), "sha256_e": (1, 1),
        "verify_epilogue": (1, 1), "verify_prologue": (1, 1)}


@pytest.mark.cuda
def test_raft_join_and_follower_on_card(cuda_device, tmp_path):
    """A three-orderer Raft network adds orderer3 by a config update;
    orderer3 joins from that block, replicating and verifying the chain
    on the card, and orders with the cluster; orderer4 follows.  The
    follower's chain and orderer3's replicated blocks equal the
    source's byte for byte; the card verified every replicated block."""
    from fabric_mod_tpu_torch import e2e
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.channelconfig import (compute_update,
                                                    signed_update_envelope)
    from fabric_mod_tpu_torch.protos import messages as m
    import time
    material = fixtures.make_network_material(
        6, consensus_type="etcdraft", orderers=3, spare_orderers=2,
        max_message_count=8, batch_timeout="200ms")
    net = e2e.Network(str(tmp_path), material=material,
                      verifier=gpu.GpuVerifier(cache_size=0),
                      election_timeout=(5.0, 10.0), heartbeat_s=0.5)
    try:
        src = net.orderers[0].support
        envs = [env for env, ok in fixtures.make_e2e_stream(net, 24)[0] if ok]

        def wait(pred, timeout=60):
            deadline = time.monotonic() + timeout
            while not pred() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert pred()

        def ordered():
            return sum(len(src.store.get_block_by_number(i).data.data)
                       for i in range(1, src.store.height))
        for env in envs[:12]:
            net.broadcast.submit(env)
        wait(lambda: ordered() >= 12)
        cur = src.bundle().config
        desired = fixtures.config_with_consenters(
            cur, list(src.bundle().orderer.consenters()) + ["orderer3"])
        net.broadcast.submit(signed_update_envelope(
            net.channel_id, compute_update(net.channel_id, cur,
                                           desired.channel_group),
            [net.orderer_admin]))
        wait(lambda: all(o.support.sequence() == 1 for o in net.orderers))
        join_block = src.store.get_block_by_number(src.writer.last_config)
        h = join_block.header.number + 1
        before = dict(p256_core.counts())
        joined = net.join_orderer("orderer3", join_block)
        assert p256_core.counts()["verify_prologue"] >= \
            before["verify_prologue"] + h - 1      # one a signed block
        follower = net.join_orderer("orderer4",
                                    m.Block.decode(material.genesis),
                                    as_follower=True)
        for env in envs[12:]:
            net.broadcast.submit(env)
        wait(lambda: ordered() >= len(envs))
        wait(lambda: len({o.support.store.height
                          for o in net.orderers}) == 1)
        raw = [[o.support.store.get_block_by_number(i).encode()
                for i in range(o.support.store.height)]
               for o in (net.orderers[0], joined, follower)]
        assert raw[2] == raw[0]
        assert raw[1][:h] == raw[0][:h] and len(raw[1]) > h
    finally:
        net.close()
