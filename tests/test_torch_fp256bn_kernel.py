"""The idemix pairing kernels (fabric_mod_tpu_torch/csrc/fp256bn_pairing.cu,
fp256bn_field.cuh and the generated fp256bn_programs.cuh) compiled by the
host C++ compiler (tests/_torch_fp256bn_shim.py), on the CPU.

Every case is exact: integers, no tolerance.  The field operations (the
carry-chain product and square, the linear-form sums, the divsteps
inverse) are held against Python ints (seeded values and the edges 0, 1,
p - 1 and R mod p); each round-split Fp12 program against the JAX
reference's operation (fabric_mod_tpu/ops/fp256bn_dev.py, run eagerly on
the same seeded numpy inputs), coefficient by coefficient as canonical
ints (the reference works in Montgomery form with R = 2^270, the kernels
with R = 2^256), and the Fp2 and Fp6 formulas the programs are generated
from likewise; the Granger-Scott square against the generic one; the
kernels' Miller lanes and full pairings against the pinned reference
vectors (tests/_fixtures/fp256bn_pairing_vectors.json, read only); the
check lanes against the plain `pairing_check_batch(device="cpu")`; the
shim's count of products, squares, inverses and rounds against
`fp256bn_programs.design_counts` and its pricing for the chip run's
bound; and `fp256bn_cuda.products_per_lane`, the reference's count,
against the products the plain version runs on one lane."""
import json
import os
import random
import re

import numpy as np
import pytest
import torch

from fabric_mod_tpu.ops import fp256bn_dev as J
from fabric_mod_tpu_torch.idemix import fp256bn as host
from fabric_mod_tpu_torch.ops import fp256bn_cuda as C
from fabric_mod_tpu_torch.ops import fp256bn_dev as T
from fabric_mod_tpu_torch.ops import fp256bn_programs as F
from fabric_mod_tpu_torch.ops import limbs9
from fabric_mod_tpu_torch.utils import fixtures
from tests import _torch_fp256bn_shim as shim
from tests._torch_fp256bn_planes import BATCH, P, _planes, j2, j6, j12, jleaves

R256 = 1 << 256
R256_INV = pow(R256, -1, P)
R270_INV = pow(1 << 270, -1, P)
_VEC_PATH = os.path.join(os.path.dirname(__file__), "_fixtures",
                         "fp256bn_pairing_vectors.json")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    built = shim.build(tmp_path_factory.mktemp("fp256bn_shim"))
    if built is None:
        pytest.skip("no host C++ compiler (g++) to build the kernels' "
                    "lanes")
    return built


@pytest.fixture(scope="module")
def pinned():
    with open(_VEC_PATH) as fh:
        data = json.load(fh)
    pts = data["points"]
    w = int(pts["w"], 16)
    g2 = host.g2_generator()

    def fp12_of(vals):
        v = [int(s, 16) for s in vals]
        return _fp12([v[c] for c in range(12)])
    return {
        "g2": g2, "w": w, "W": host.g2_mul(w, g2),
        "P": [host.G1(*(int(v, 16) for v in pts[k])) for k in ("P1", "P2")],
        "miller": [fp12_of(f) for f in data["miller"]],
        "pairing": [fp12_of(f) for f in data["pairing"]],
    }


def _fp12(v):
    """12 ints, coefficient c = 6h + 2i + j -> host.Fp12."""
    def fp6(o):
        return host.Fp6(host.Fp2(v[o], v[o + 1]), host.Fp2(v[o + 2], v[o + 3]),
                        host.Fp2(v[o + 4], v[o + 5]))
    return host.Fp12(fp6(0), fp6(6))


def _planes_fp12(planes: np.ndarray, lane: int) -> "host.Fp12":
    """The lane's host Fp12 of (12, 8, n) canonical word planes."""
    return _fp12([shim.ints(planes[c][:, lane])[0] for c in range(12)])


# --- (0) the source's constants ---------------------------------------------

def _words_of(name: str, header: str = "fp256bn_field.cuh") -> int:
    text = shim.SRC.with_name(header).read_text()
    body = re.search(name + r"\[\d*\] = \{([^}]*)\}", text).group(1)
    ws = [int(w.rstrip("u"), 16) for w in re.findall(r"0x[0-9A-F]+u?", body)]
    bits = 30 if name.endswith("30") else 32
    return sum(w << (bits * k) for k, w in enumerate(ws))


def test_field_constants():
    assert _words_of("kBnP") == P == T.host.P
    assert _words_of("kBnP30") == P
    assert _words_of("kBnR2") == R256 * R256 % P
    assert _words_of("kBnOneM") == R256 % P < 1 << 210
    assert _words_of("kBnR3") == pow(R256, 3, P)
    assert _words_of("kBnNegK") == 2 * P + 1 - R256
    text = shim.SRC.with_name("fp256bn_field.cuh").read_text()
    assert int(re.search(r"kBnP0Inv = (0x[0-9A-F]+)u", text).group(1),
               16) == (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert int(re.search(r"kBnPInv30 = (0x[0-9A-F]+)u", text).group(1),
               16) == pow(P, -1, 1 << 30)
    assert int(re.search(r"kBnAbsU = (0x[0-9A-F]+)ull", text).group(1),
               16) == abs(host.U)


def test_programs_header_is_generated():
    """csrc/fp256bn_programs.cuh is what the generator writes, and its
    constants are the generator's (Montgomery form but for r2 and one)."""
    assert F.HEADER_PATH.read_text() == F.header()
    assert F.const_words()[F.CONST_INDEX["r2"]] == R256 * R256 % P
    frob = F._frob_consts()
    assert F.const_words()[F.CONST_INDEX["frob3_1"]] == frob[3].b * R256 % P


# --- (1) the field ---------------------------------------------------------------

_EDGES = [0, 1, P - 1, R256 % P]


def _field_operands():
    rng = random.Random(16)
    a = [rng.randrange(P) for _ in range(40)] + _EDGES * 4
    b = [rng.randrange(P) for _ in range(40)] + [e for e in _EDGES
                                                for _ in range(4)]
    return a, b


_FIELD = {
    "mul": (shim.FP_MUL, lambda a, b: a * b * R256_INV % P),
    "sqr": (shim.FP_SQR, lambda a, b: a * a * R256_INV % P),
    "add": (shim.FP_ADD, lambda a, b: (a + b) % P),
    "sub": (shim.FP_SUB, lambda a, b: (a - b) % P),
    "neg": (shim.FP_NEG, lambda a, b: -a % P),
    # the inverse in the Montgomery domain: (a/R)^-1 * R; 0 maps to 0
    "inv": (shim.FP_INV,
            lambda a, b: pow(a * R256_INV, -1, P) * R256 % P if a else 0),
    "to_mont": (shim.FP_TO_MONT, lambda a, b: a * R256 % P),
    "from_mont": (shim.FP_FROM_MONT, lambda a, b: a * R256_INV % P),
}


@pytest.mark.parametrize("op", sorted(_FIELD))
def test_field_op_against_ints(lib, op):
    code, want = _FIELD[op]
    a, b = _field_operands()
    got = shim.fp_ops(lib, code, a, b)
    assert got == [want(x, y) for x, y in zip(a, b)]
    assert all(v < P for v in got)


# --- (2) the tower against the JAX reference --------------------------------------

def _ref_ints(planes) -> list:
    """Reference limb planes (n, K, BATCH), lazy or not -> [leaf][lane]
    canonical ints."""
    return [[limbs9.limbs_to_int(np.asarray(leaf)[:, b]) * R270_INV % P
             for b in range(BATCH)] for leaf in planes]


def _records(planes) -> np.ndarray:
    """(n, K, BATCH) reference planes -> (BATCH, 96) shim records of their
    kernel-domain (R = 2^256) words."""
    leaves = _ref_ints(planes)
    rec = np.zeros((BATCH, 96), np.uint32)
    for c, vals in enumerate(leaves):
        rec[:, 8 * c:8 * c + 8] = shim.words([v * R256 % P for v in vals])
    return rec


def _record_ints(rec: np.ndarray, n_leaves: int) -> list:
    """(BATCH, 96) shim records -> [leaf][lane] canonical ints."""
    return [[v * R256_INV % P for v in shim.ints(rec[:, 8 * c:8 * c + 8])]
            for c in range(n_leaves)]


def _cyclotomic_planes(rng, n_lanes: int = BATCH):
    """(12, K, BATCH) reference planes of seeded Fp12 values taken
    through the easy part (into the cyclotomic subgroup)."""
    vals = []
    for _ in range(n_lanes):
        f = _host12([rng.randrange(P) for _ in range(12)])
        f = f.conj() * f.inv()
        vals.append(_flat12(f.frobenius().frobenius() * f))
    return np.stack([np.stack([T._mont_np(vals[b][c]) for b in range(n_lanes)],
                              -1) for c in range(12)])


def _host12(v) -> "host.Fp12":
    return _fp12(list(v))


def _flat12(x) -> list:
    return [c for h in (x.c0, x.c1) for f2 in (h.c0, h.c1, h.c2)
            for c in (f2.a, f2.b)]


def _tower_cases():
    rng = random.Random(161)
    x2, y2 = _planes(rng, 2), _planes(rng, 2)
    x6, y6 = _planes(rng, 6), _planes(rng, 6)
    x12, y12 = _planes(rng, 12), _planes(rng, 12)
    yp, A, B = _planes(rng, 1), _planes(rng, 2), _planes(rng, 2)
    c12 = _cyclotomic_planes(rng)
    # (the kernels' program, or None for a formula the programs are
    # generated from; its arguments; the reference)
    return {
        "f2_mul": (F.f2_mul, (x2, y2), lambda: J.f2_mul(j2(x2), j2(y2))),
        "f2_sqr": (F.f2_sqr, (x2,), lambda: J.f2_sqr(j2(x2))),
        "f2_inv": (F.f2_inv, (x2,), lambda: J.f2_inv(j2(x2))),
        "f6_mul": (F.f6_mul, (x6, y6), lambda: J.f6_mul(j6(x6), j6(y6))),
        "f6_mul_sparse12": (F.f6_mul_sparse12, (x6, A, B),
                            lambda: J.f6_mul_sparse12(j6(x6), j2(A), j2(B))),
        "f6_inv": (F.f6_inv, (x6,), lambda: J.f6_inv(j6(x6))),
        "f12_mul": ("f12_mul", (x12, y12),
                    lambda: J.f12_mul(j12(x12), j12(y12))),
        "f12_sqr": ("f12_sqr", (x12,), lambda: J.f12_sqr(j12(x12))),
        "f12_cyclotomic_sqr": ("f12_cyclotomic_sqr", (c12,),
                               lambda: J.f12_sqr(j12(c12))),
        "f12_mul_line": ("f12_mul_line", (x12, yp, A, B),
                         lambda: J.f12_mul_line(j12(x12), yp[0], j2(A),
                                                j2(B))),
        "f12_frobenius": ("f12_frobenius", (x12,),
                          lambda: J.f12_frobenius(j12(x12))),
        "f12_inv": ("f12_inv", (x12,), lambda: J.f12_inv(j12(x12))),
    }


_TOWER = sorted(_tower_cases())


def _nested(vals, n):
    """n canonical Fp values -> the formulas' nesting (Fp2 pairs, Fp6
    triples of pairs)."""
    v = [F.Num(x) for x in vals]
    if n == 1:
        return v[0]
    if n == 2:
        return (v[0], v[1])
    return tuple((v[2 * i], v[2 * i + 1]) for i in range(3))


def _leaf_ints(x) -> list:
    if isinstance(x, F.Num):
        return [x.v]
    return [v for c in x for v in _leaf_ints(c)]


@pytest.mark.parametrize("op", _TOWER)
def test_tower_op_against_reference(lib, op):
    """A round-split Fp12 program (the g++ build of the kernels'
    interpreter, output not aliasing x), or an Fp2 / Fp6 formula the
    programs are made of (on ints), against the reference's operation."""
    prog, args, ref = _tower_cases()[op]
    want = _ref_ints(jleaves(ref()))
    if isinstance(prog, str):
        got = shim.program_ops(lib, prog, *(_records(a) for a in args))
        assert _record_ints(got, 12) == want
        return
    per_lane = [[_nested([leaf[b] for leaf in _ref_ints(a)], len(a))
                 for a in args] for b in range(BATCH)]
    got = [_leaf_ints(prog(*lane)) for lane in per_lane]
    assert [[got[b][c] for b in range(BATCH)] for c in range(len(want))] == want


@pytest.mark.parametrize("prog", [p for p in F.PROGRAM_ORDER
                                  if p.startswith("f12_")])
def test_program_in_place(lib, prog):
    """Every Fp12 program may write over its x: in place, the same words
    as into a separate output (f12_conj runs in place only: against the
    host's conjugate)."""
    rng = random.Random(7)
    x = _records(_planes(rng, 12))
    y, z, w = (_records(_planes(rng, 12)) for _ in range(3))
    got = shim.program_ops(lib, prog, x, y, z, w, inplace=True)
    if prog == "f12_conj":
        for b, vals in enumerate(zip(*_record_ints(x, 12))):
            assert [v for v in zip(*_record_ints(got, 12))][b] == tuple(
                _flat12(_host12(vals).conj()))
        return
    assert np.array_equal(got, shim.program_ops(lib, prog, x, y, z, w))


@pytest.mark.parametrize("prog", [p for p in F.PROGRAM_ORDER
                                  if p.startswith("f12_")
                                  and p not in ("f12_to_mont",
                                                "f12_from_mont")])
def test_program_tables_on_ints(prog):
    """The generated tables themselves, evaluated on ints, against the
    host tower (fabric_mod_tpu_torch/idemix/fp256bn.py)."""
    rng = random.Random(11)
    x = [rng.randrange(P) for _ in range(12)]
    if prog == "f12_cyclotomic_sqr":
        f = _host12(x)
        f = f.conj() * f.inv()
        x = _flat12(f.frobenius().frobenius() * f)
    y = [rng.randrange(P) for _ in range(12)]
    fx = _host12(x)
    z2 = host.Fp2(0)
    want = {
        "f12_mul": lambda: fx * _host12(y),
        "f12_sqr": lambda: fx.sqr(),
        "f12_cyclotomic_sqr": lambda: fx.sqr(),
        "f12_frobenius": lambda: fx.frobenius(),
        "f12_conj": lambda: fx.conj(),
        "f12_inv": lambda: fx.inv(),
        "f12_mul_line": lambda: fx * host.Fp12(
            host.Fp6(host.Fp2(y[0]), z2, z2),
            host.Fp6(z2, host.Fp2(y[1], y[2]), host.Fp2(y[3], y[4]))),
    }[prog]()
    args = {"x": x, "y": y}
    if prog == "f12_mul_line":
        args = {"x": x, "y": y[:1], "z": y[1:3], "w": y[3:5]}
    assert F.PROGRAMS[prog].evaluate(**args) == _flat12(want)


def test_cyclotomic_sqr_equals_the_square(lib):
    """Granger-Scott's square equals the generic Fp12 square on seeded
    values taken through the easy part, and on 0 (the value of a zero
    lane), in the kernels' programs."""
    rng = random.Random(29)
    c = _records(_cyclotomic_planes(rng))
    zero = np.zeros((1, 96), np.uint32)
    for x in (c, zero):
        assert np.array_equal(
            shim.program_ops(lib, "f12_cyclotomic_sqr", x),
            shim.program_ops(lib, "f12_sqr", x))
    assert not shim.program_ops(lib, "f12_cyclotomic_sqr", zero).any()


# --- (3) the kernels' lanes against the pinned vectors -----------------------------

def _miller_inputs(points, q):
    sched = T.line_schedule(q)
    return (C.point_words(points)[None], sched.line_words()[None],
            sched.is_add.astype(np.int32))


def test_line_words_are_the_schedule(pinned):
    """The kernels' line constants are the limb schedule's values."""
    sched = T.line_schedule(pinned["W"])
    words = sched.line_words()
    assert words.shape == (len(sched.is_add) + 2, 4, 8)
    A = np.concatenate([sched.A, sched.corr_A])
    B = np.concatenate([sched.B, sched.corr_B])
    for s in (0, 7, len(words) - 1):
        for q, limb in enumerate((A[s, 0], A[s, 1], B[s, 0], B[s, 1])):
            want = limbs9.limbs_to_int(limb) * R270_INV % P
            assert shim.ints(words[s, q])[0] == want


def test_miller_lanes_match_pinned_vectors(lib, pinned):
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    out = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32), is_add)
    for i in range(2):
        assert _planes_fp12(out[0], i) == pinned["miller"][i]


def test_pairing_lanes_match_pinned_vectors(lib, pinned):
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    f = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32), is_add)
    out = shim.final_exp(lib, f, check=False)
    for i in range(2):
        assert _planes_fp12(out, i) == pinned["pairing"][i]


def test_plain_versions_equal_the_lanes(lib, pinned):
    """On CPU tensors the kernels' wrappers are the plain versions: the
    same words as the host-compiled lanes, and no launch counted."""
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    C.reset_counts()
    f = C.miller(torch.from_numpy(pts), torch.from_numpy(lines),
                 torch.from_numpy(is_add))
    lanes = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32),
                        is_add)
    assert np.array_equal(f.numpy().view(np.uint32), lanes)
    out = C.final_exp(f, check=False)
    assert np.array_equal(out.numpy().view(np.uint32),
                          shim.final_exp(lib, lanes, check=False))
    assert C.counts() == {name: 0 for name in C.KERNELS}
    g = C.f12_from_words(out)
    for i in range(2):
        assert T.f12_to_host(g, i) == pinned["pairing"][i]


# --- (4) the check -------------------------------------------------------------------

def _check_lanes(lib, a_points, q1, b_points, q2):
    s1, s2 = T.line_schedule(q1), T.line_schedule(q2)
    pts = np.stack([C.point_words(a_points), C.point_words(b_points)])
    lines = np.stack([s1.line_words(), s2.line_words()])
    f = shim.miller(lib, pts.view(np.uint32), lines.view(np.uint32),
                    s1.is_add.astype(np.int32))
    return shim.final_exp(lib, f, check=True)


def test_check_ver_shaped(lib, pinned):
    """e(A, W) == e(w·A, g2), and not for w·A + G: [True, False], as the
    plain check on the CPU gives."""
    A = pinned["P"][0]
    Abar = host.g1_mul(pinned["w"], A)
    bad = host.g1_add(Abar, host.G1.generator())
    args = ([A, A], pinned["W"], [Abar.neg(), bad.neg()], pinned["g2"])
    got = _check_lanes(lib, *args)
    assert got.tolist() == [True, False]
    assert got.tolist() == T.pairing_check_batch(*args, device="cpu").tolist()


def test_check_tampered_lanes_equal_plain(lib):
    world = fixtures.make_idemix_world(seed=5, n_users=1)
    a, abar, expect = fixtures.make_pairing_lanes(world, 6, tamper_every=3,
                                                  seed=5)
    ik = world.issuer.key
    args = (a, ik.W, [p.neg() for p in abar], ik.g2)
    got = _check_lanes(lib, *args)
    assert got.tolist() == expect.tolist() == [True, True, False] * 2
    assert got.tolist() == T.pairing_check_batch(*args, device="cpu").tolist()


# --- (5) the work a lane needs --------------------------------------------------------

def test_products_per_lane(pinned, monkeypatch):
    """products_per_lane is the reference's count (its formulas, with the
    generic square, the Fermat inverse and conversions in and out of the
    Montgomery domain): the Montgomery reductions the plain version runs
    on one lane, counted as it runs, plus the conversions the kernels
    make at their boundary (the plain version's points and values are in
    the Montgomery domain already)."""
    run = [0]
    reduce = limbs9._mont_reduce

    def counted(t, spec):
        out = reduce(t, spec)
        run[0] += out.numel() // limbs9.K     # one lane: an Fp a product
        return out
    monkeypatch.setattr(limbs9, "_mont_reduce", counted)
    sched = T.line_schedule(pinned["W"])
    is_add = sched.is_add
    xs, ys = T._g1_batch_to_mont(pinned["P"][:1], torch.device("cpu"))
    f = T.miller_batch(xs, ys, sched)
    miller = run[0]
    run[0] = 0
    T.final_exp_batch(f)
    pairing = run[0]
    run[0] = 0
    T.f12_mul(f, f)
    f12_mul = run[0]
    # the Miller lane: x, y in; the Fp12 out
    assert C.products_per_lane(is_add, "fp256bn_miller") == 2 + miller + 12
    # pairing mode: the Fp12 in and out; check mode: two in, their product
    assert C.products_per_lane(is_add, "fp256bn_final_exp",
                               check=False) == 12 + pairing + 12
    assert C.products_per_lane(is_add, "fp256bn_final_exp",
                               check=True) == 24 + f12_mul + pairing


def test_design_counts(lib, pinned):
    """The shim's count of Fp products (squares among them), inverses and
    product rounds run equals fp256bn_programs.design_counts (a lane of
    each kernel, plus each schedule's A values into the Montgomery
    domain, 2 a step, once a block): the design's own work, which
    fp256bn_cuda.multiply_adds_per_lane prices for the bound."""
    pts, lines, is_add = _miller_inputs(pinned["P"], pinned["W"])
    pts2, lines2 = np.concatenate([pts, pts]), np.concatenate([lines, lines])
    n, S, steps = pts.shape[-1], 2, lines.shape[1]
    shim.counts(lib)
    f = shim.miller(lib, pts2.view(np.uint32), lines2.view(np.uint32), is_add)
    miller = F.design_counts(is_add, "fp256bn_miller")
    assert shim.counts(lib) == {
        "products": S * (n * miller["products"] + 2 * steps),
        "squares": S * n * miller["squares"],
        "inverses": 0, "rounds": S * n * miller["rounds"]}
    for check in (True, False):
        shim.final_exp(lib, f if check else f[:1], check=check)
        want = F.design_counts(is_add, "fp256bn_final_exp", check=check)
        ran = shim.counts(lib)
        assert ran == {k: n * v for k, v in want.items()}
        # the bound prices the kernels' own work as the g++ build ran it
        madds = C.multiply_adds_per_lane(is_add, "fp256bn_final_exp", check)
        assert madds["design"] * n == (
            (ran["products"] - ran["squares"]) * C.MULTIPLY_ADDS
            + ran["squares"] * C.SQUARE_MULTIPLY_ADDS)
        assert madds["least"] == madds["design"] < madds["reference"]
    # the design runs fewer products than the reference's count
    assert miller["products"] < C.products_per_lane(is_add, "fp256bn_miller")
    assert want["products"] < C.products_per_lane(
        is_add, "fp256bn_final_exp", check=False)
