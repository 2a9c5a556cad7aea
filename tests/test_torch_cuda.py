"""The CUDA ladder kernels (fabric_mod_tpu_torch/csrc/p256_ladder.cu).

Tests marked `cuda` need a card and skip without one; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The others run anywhere: the source's constants against values computed
here, and — since the kernels' field and point arithmetic is plain C++
outside `__CUDACC__` — that arithmetic compiled by the host C++ compiler
and held bit-equal to the plain PyTorch ladders."""
import ctypes
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fabric_mod_tpu_torch.ops import _build, limbs9, p256, p256_cuda

SRC = _build.source_path("p256_ladder")
R256 = 1 << 256
R270 = 1 << 270


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
    text = SRC.read_text()

    def array(name):
        body = re.search(name + r"\[8\] = \{([^}]*)\}", text).group(1)
        return [int(x.strip().rstrip("u"), 16) for x in body.split(",")]
    P = p256.P
    assert array("kP") == _words(P)
    assert array("kR2") == _words(R256 * R256 % P)
    assert array("kOneM") == _words(R256 % P)
    assert array("kBM") == _words(p256.B * R256 % P)
    assert (-pow(P, -1, 1 << 32)) % (1 << 32) == 1   # the CIOS shortcut


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


def test_kernel_arithmetic_on_host_compiler(tmp_path):
    """The kernels' per-lane code (ladder_*_lane) built by g++ for the
    host gives the plain ladders' exact canonical outputs."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    shim = tmp_path / "lanes.cpp"
    shim.write_text(
        f'#include "{SRC}"\n'
        'extern "C" void lanes(int mixed, const int32_t* u1, '
        'const int32_t* u2, const uint32_t* qx, const uint32_t* qy, '
        'const uint32_t* g, uint32_t* X, uint32_t* Y, uint32_t* Z, int n) {\n'
        '  const Fe* gt = reinterpret_cast<const Fe*>(g);\n'
        '  for (int lane = 0; lane < n; ++lane) {\n'
        '    if (mixed) ladder_mixed_lane(lane, n, u1, u2, qx, qy, gt, X, Y, Z);\n'
        '    else ladder_projective_lane(lane, n, u1, u2, qx, qy, gt, X, Y, Z);\n'
        '  }\n}\n')
    lib_path = tmp_path / "liblanes.so"
    subprocess.run([cxx, "-O0", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-x", "c++", "-o", str(lib_path),
                    str(shim)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.lanes.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int]
    lib.lanes.restype = None
    n = 6
    u1, u2, qx, qy = _ladder_case(n)
    qxw = p256_cuda.mont_limbs_to_words(qx).numpy().copy()
    qyw = p256_cuda.mont_limbs_to_words(qy).numpy().copy()
    u1n, u2n = u1.numpy().copy(), u2.numpy().copy()
    for mixed in (False, True):
        g = np.ascontiguousarray(p256_cuda.g_table_words(mixed))
        out = [np.zeros((8, n), np.int32) for _ in range(3)]
        lib.lanes(int(mixed), u1n.ctypes.data, u2n.ctypes.data,
                  qxw.ctypes.data, qyw.ctypes.data, g.ctypes.data,
                  *(o.ctypes.data for o in out), n)
        want = _plain_words(mixed, u1, u2, qx, qy)
        for o, w, coord in zip(out, want, "XYZ"):
            got = p256_cuda.from_u32_bits(torch.from_numpy(o))
            assert torch.equal(got, w), (mixed, coord)


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, mixed):
    """At a ragged width (not a multiple of 128), with edge and invalid
    lanes: the kernel's canonical X, Y, Z are bit-equal to the plain
    ladder's on the card, and its launch count rises by one."""
    n = 300
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
def test_gpu_verifier_on_card(cuda_device):
    from fabric_mod_tpu_torch.bccsp import gpu
    from fabric_mod_tpu_torch.utils import fixtures
    items, expect = fixtures.make_block(1, n_tx=40, raw_endorsers=True)
    for ladder in gpu.LADDERS:
        name = p256_cuda.KERNELS[ladder == "mixed"]
        before = p256_cuda.counts()[name]
        got = gpu.GpuVerifier(ladder=ladder, cache_size=0).verify_many(items)
        assert got.tolist() == expect.tolist()
        assert p256_cuda.counts()[name] > before
