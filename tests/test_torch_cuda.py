"""The CUDA ladder kernels (fabric_mod_tpu_torch/csrc/p256_ladder.cu) and the
other device paths of the port on the card (the policy evaluator, a
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
    from fabric_mod_tpu_torch.utils import fixtures
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
def test_pairing_check_on_card_equals_cpu(cuda_device):
    """The batched FP256BN pairing check on the card gives the CPU plain
    run's verdicts on 8 lanes (two of them tampered), as a CUDA tensor."""
    from fabric_mod_tpu_torch.ops import fp256bn_dev as dev
    from fabric_mod_tpu_torch.utils import fixtures
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
    from fabric_mod_tpu_torch.utils import fixtures
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
