"""The idemix pairing kernels' tower operations as programs of rounds.

csrc/fp256bn_pairing.cu runs a lane of a pairing as a group of G = 16
threads of one warp.  Each Fp12 operation there is a program: stages of
independent items, each item one Fp product (or one Fp inverse) of two
operands, or one output sum.  An operand or an output is a linear form:
a signed sum of Fp values (`slots`) of the operation's arguments, its
own earlier products and a few constants.  Rank g of a group runs items
g, g + G, ... of a stage, and the group meets at `__syncwarp` between
stages, so a stage of K products costs ceil(K / G) product latencies (a
`round`).  The programs live in csrc/fp256bn_programs.cuh as tables,
which `main()` here writes:

    python -m fabric_mod_tpu_torch.ops.fp256bn_programs

The tower formulas below are written once over any values with +, -,
unary -, * (an Fp product, or an integer scale) and `.inv()`.  Run on
`Num` (ints mod p) they compute; run on `Lin` (linear forms) they record
the items of a program.  Every value the kernels hold is fully reduced,
so any correct formula gives the reference's words exactly: the
cyclotomic square here is Granger-Scott's (PKC 2010), not the
reference's generic square.

`design_counts` counts the products, inverses and rounds a lane of each
kernel runs under this design, mirroring the kernels' control flow (the
g++ build of the kernels counts them too, and the tests hold the two
equal); `fp256bn_cuda.products_per_lane` stays the reference's count,
which the bound is computed from.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from fabric_mod_tpu_torch.idemix import fp256bn as host

P = host.P
R = 1 << 256
G = 16                     # threads a lane: products a round

# a slot's argument: the output, up to four inputs, the program's
# products, the block's constants
ARGS = ("d", "x", "y", "z", "w", "t", "k")
# item kinds (one a stage)
MUL, SQR, INV, SUM = range(4)
KIND_NAMES = ("kBnMul", "kBnSqr", "kBnInv", "kBnSum")
# a term: index (9 bits), argument (3 bits), signed coefficient (4 bits)
MAX_COEFF = 7
# the lazy accumulator's headroom: sum of |coefficient| over a form
MAX_WEIGHT = 63


# --- constants (the block's shared table, in Fp units) ------------------------

def _frob_consts() -> List["host.Fp2"]:
    f12 = host._FROB12
    return [host._FROB6_1, host._FROB6_2, f12, f12 * host._FROB6_1,
            f12 * host._FROB6_2]


# name -> plain value; the kernels hold them in the Montgomery domain
# except `one` (the from-Montgomery multiplier) and `r2` (the
# to-Montgomery multiplier), which are raw words
CONSTS: List[Tuple[str, int]] = [("r2", R * R % P), ("one", 1), ("zero", 0)] + [
    (f"frob{k}_{c}", v) for k, f in enumerate(_frob_consts())
    for c, v in enumerate((f.a, f.b))]
CONST_INDEX = {name: i for i, (name, _) in enumerate(CONSTS)}
RAW_CONSTS = ("r2", "one")


def const_words() -> List[int]:
    """The constants table as the kernels hold it (Montgomery form, but
    for the raw multipliers)."""
    return [v if name in RAW_CONSTS else v * R % P for name, v in CONSTS]


# --- backends -------------------------------------------------------------------

class Num:
    """An Fp value (plain, mod p)."""
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % P

    def __add__(self, o): return Num(self.v + o.v)
    def __sub__(self, o): return Num(self.v - o.v)
    def __neg__(self): return Num(-self.v)

    def __mul__(self, o):
        return Num(self.v * (o if isinstance(o, int) else o.v))

    __rmul__ = __mul__

    def inv(self):
        return Num(pow(self.v, -1, P) if self.v else 0)


class Lin:
    """A linear form over slots ((argument, index) -> coefficient) of
    one program being built."""
    __slots__ = ("b", "terms")

    def __init__(self, b: "Builder", terms: Dict[Tuple[str, int], int]):
        self.b = b
        self.terms = {s: c for s, c in terms.items() if c}

    def _merge(self, o, sign):
        t = dict(self.terms)
        for s, c in o.terms.items():
            t[s] = t.get(s, 0) + sign * c
        return Lin(self.b, t)

    def __add__(self, o): return self._merge(o, 1)
    def __sub__(self, o): return self._merge(o, -1)
    def __neg__(self): return Lin(self.b, {s: -c for s, c in self.terms.items()})

    def __mul__(self, o):
        if isinstance(o, int):
            return Lin(self.b, {s: c * o for s, c in self.terms.items()})
        return self.b.item(MUL, self, o)

    __rmul__ = __mul__

    def inv(self):
        return self.b.item(INV, self, None)


class Item:
    __slots__ = ("kind", "a", "b", "level", "dst")

    def __init__(self, kind, a, b, level, dst):
        self.kind, self.a, self.b, self.level, self.dst = kind, a, b, level, dst


class Builder:
    """Records a program's items: products and inverses in levels (an
    item's level is one more than its operands' deepest product), then
    the output sums."""

    def __init__(self):
        self.items: List[Item] = []
        self._seen: Dict[tuple, Lin] = {}

    def _level(self, form: Lin) -> int:
        return max((self.items[i].level for (a, i) in form.terms if a == "t"),
                   default=0)

    def item(self, kind, a: Lin, b) -> Lin:
        if not a.terms or (b is not None and not b.terms):
            return Lin(self, {})            # a product by zero
        if kind == MUL and a.terms == b.terms:
            kind, b = SQR, None
        key = (kind, frozenset(a.terms.items()),
               None if b is None else frozenset(b.terms.items()))
        alt = (kind, key[2], key[1])
        for k in (key, alt):
            if k in self._seen:
                return self._seen[k]
        level = 1 + max(self._level(a), 0 if b is None else self._level(b))
        self.items.append(Item(kind, a, b, level, ("t", len(self.items))))
        out = Lin(self, {("t", len(self.items) - 1): 1})
        self._seen[key] = out
        return out

    def arg(self, name: str, n: int) -> List[Lin]:
        return [Lin(self, {(name, i): 1}) for i in range(n)]

    def const(self, name: str) -> Lin:
        v = dict(CONSTS)[name]
        return Lin(self, {("k", CONST_INDEX[name]): 1} if v else {})


# --- the tower (the reference's formulas; tuples of Fp values) -----------------

def f2_add(x, y): return (x[0] + y[0], x[1] + y[1])
def f2_sub(x, y): return (x[0] - y[0], x[1] - y[1])
def f2_neg(x): return (-x[0], -x[1])
def f2_conj(x): return (x[0], -x[1])
def f2_mul_xi(x): return (x[0] - x[1], x[0] + x[1])
def f2_mul_fp(x, s): return (x[0] * s, x[1] * s)


def f2_mul(x, y):
    t0, t1 = x[0] * y[0], x[1] * y[1]
    t2 = (x[0] + x[1]) * (y[0] + y[1])
    return (t0 - t1, t2 - t0 - t1)


def f2_sqr(x):
    m = x[0] * x[1]
    return ((x[0] + x[1]) * (x[0] - x[1]), m + m)


def f2_inv(x):
    d = (x[0] * x[0] + x[1] * x[1]).inv()
    return (x[0] * d, -(x[1] * d))


def f6_add(x, y): return tuple(f2_add(a, b) for a, b in zip(x, y))
def f6_sub(x, y): return tuple(f2_sub(a, b) for a, b in zip(x, y))
def f6_neg(x): return tuple(f2_neg(a) for a in x)
def f6_mul_v(x): return (f2_mul_xi(x[2]), x[0], x[1])
def f6_mul_fp(x, s): return tuple(f2_mul_fp(a, s) for a in x)


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)),
                                 f2_add(t1, t2))), t0)
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_mul_sparse12(x, b1, b2):
    a0, a1, a2 = x
    t1, t2 = f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)),
                          f2_add(t1, t2)))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), b1), t1), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), b2), t2), t1)
    return (c0, c1, c2)


def f6_inv(x):
    a0, a1, a2 = x
    t0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    t1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    t2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    d = f2_add(f2_mul(a0, t0),
               f2_add(f2_mul_xi(f2_mul(a2, t1)), f2_mul_xi(f2_mul(a1, t2))))
    di = f2_inv(d)
    return (f2_mul(t0, di), f2_mul(t1, di), f2_mul(t2, di))


def f12_mul(x, y):
    t0, t1 = f6_mul(x[0], y[0]), f6_mul(x[1], y[1])
    return (f6_add(t0, f6_mul_v(t1)),
            f6_sub(f6_mul(f6_add(x[0], x[1]), f6_add(y[0], y[1])),
                   f6_add(t0, t1)))


def f12_sqr(x):
    a0, a1 = x
    t0 = f6_mul(a0, a1)
    c0 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_v(a1))),
                f6_add(t0, f6_mul_v(t0)))
    return (c0, f6_add(t0, t0))


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_inv(x):
    t = f6_inv(f6_sub(f6_mul(x[0], x[0]), f6_mul_v(f6_mul(x[1], x[1]))))
    return (f6_mul(x[0], t), f6_neg(f6_mul(x[1], t)))


def f12_mul_line(f, yp, A, Bxp):
    """f * l for the sparse line l = yp + A (v w) + Bxp (v^2 w)."""
    a0, a1 = f
    t1 = f6_mul_sparse12(a1, A, Bxp)
    c1 = f6_add(f6_mul_sparse12(a0, A, Bxp), f6_mul_fp(a1, yp))
    return (f6_add(f6_mul_fp(a0, yp), f6_mul_v(t1)), c1)


def f12_frobenius(x, frob):
    """x -> x^p; `frob` the five Fp2 constants of `_frob_consts`."""
    c0, c1 = x
    return ((f2_conj(c0[0]), f2_mul(f2_conj(c0[1]), frob[0]),
             f2_mul(f2_conj(c0[2]), frob[1])),
            (f2_mul(f2_conj(c1[0]), frob[2]), f2_mul(f2_conj(c1[1]), frob[3]),
             f2_mul(f2_conj(c1[2]), frob[4])))


def f12_cyclotomic_sqr(x):
    """x^2 for x in the cyclotomic subgroup (or 0): Granger-Scott, three
    Fp4 squares of two Fp2 products each, 18 Fp products.  Fp12 as Fp4^3:
    (z0, z1) = (c0.c0, c1.c1), (z2, z3) = (c1.c0, c0.c2), (z4, z5) =
    (c0.c1, c1.c2)."""
    (z0, z4, z3), (z2, z1, z5) = x

    def fp4_sqr(a, b):
        m = f2_mul(a, b)
        return (f2_sub(f2_mul(f2_add(a, b), f2_add(f2_mul_xi(b), a)),
                       f2_add(m, f2_mul_xi(m))), f2_add(m, m))

    def scale(v, n):
        return (v[0] * n, v[1] * n)

    t0, t1 = fp4_sqr(z0, z1)
    t2, t3 = fp4_sqr(z2, z3)
    t4, t5 = fp4_sqr(z4, z5)
    return ((f2_sub(scale(t0, 3), scale(z0, 2)),
             f2_sub(scale(t2, 3), scale(z4, 2)),
             f2_sub(scale(t4, 3), scale(z3, 2))),
            (f2_add(scale(f2_mul_xi(t5), 3), scale(z2, 2)),
             f2_add(scale(t1, 3), scale(z1, 2)),
             f2_add(scale(t3, 3), scale(z5, 2))))


# Fp12 as a flat list of 12 values, coefficient c = 6h + 2i + j (the
# kernels' plane order) <-> the nested tuples above
def nest(v: Sequence) -> tuple:
    return tuple(tuple((v[6 * h + 2 * i], v[6 * h + 2 * i + 1])
                       for i in range(3)) for h in range(2))


def flat(x) -> list:
    return [x[h][i][j] for h in range(2) for i in range(3) for j in range(2)]


# --- the programs ---------------------------------------------------------------

def _frob(b: Builder):
    return [(b.const(f"frob{k}_0"), b.const(f"frob{k}_1")) for k in range(5)]


# name -> (arguments and their Fp sizes, function of the Builder and the
# arguments' values -> the output's values, dst may be the same as x)
PROGRAM_DEFS = {
    "f12_mul": ((("x", 12), ("y", 12)),
                lambda b, x, y: flat(f12_mul(nest(x), nest(y)))),
    "f12_sqr": ((("x", 12),), lambda b, x: flat(f12_sqr(nest(x)))),
    "f12_cyclotomic_sqr": ((("x", 12),),
                           lambda b, x: flat(f12_cyclotomic_sqr(nest(x)))),
    "f12_mul_line": ((("x", 12), ("y", 1), ("z", 2), ("w", 2)),
                     lambda b, x, y, z, w: flat(f12_mul_line(
                         nest(x), y[0], (z[0], z[1]), (w[0], w[1])))),
    "f12_frobenius": ((("x", 12),),
                      lambda b, x: flat(f12_frobenius(nest(x), _frob(b)))),
    # in place only: negates the w half
    "f12_conj": ((("x", 12),), lambda b, x: flat(f12_conj(nest(x)))),
    "f12_inv": ((("x", 12),), lambda b, x: flat(f12_inv(nest(x)))),
    # canonical words in and out of the Montgomery domain
    "f12_to_mont": ((("x", 12),),
                    lambda b, x: [v * b.const("r2") for v in x]),
    "f12_from_mont": ((("x", 12),),
                      lambda b, x: [v * b.const("one") for v in x]),
    # a lane's G1 point (x, y) -> (x, y) in the Montgomery domain and
    # x R^2 (times a canonical B, a product gives B x in the domain)
    "g1_to_mont": ((("x", 2),),
                   lambda b, x: [x[0] * b.const("r2"), x[1] * b.const("r2"),
                                 (x[0] * b.const("r2")) * b.const("r2")]),
}
IN_PLACE_ONLY = ("f12_conj",)


class Program:
    """A built program: stages of (kind, [items]); items' forms over
    (argument, index) slots."""

    def __init__(self, name: str):
        self.name = name
        arg_sizes, fn = PROGRAM_DEFS[name]
        b = Builder()
        args = {a: b.arg(a, n) for a, n in arg_sizes}
        outs = fn(b, *args.values())
        self.n_out = len(outs)
        self.n_temps = len(b.items)
        self.stages: List[Tuple[int, List[Item]]] = []
        for lv in sorted({it.level for it in b.items}):
            here = [it for it in b.items if it.level == lv]
            prods = [it for it in here if it.kind != INV]
            if prods and any(it.kind == MUL for it in prods):
                # one code path a stage: a square there is a product
                prods = [it if it.kind == MUL else
                         Item(MUL, it.a, it.a, lv, it.dst) for it in prods]
            if prods:
                self.stages.append((prods[0].kind, prods))
            invs = [it for it in here if it.kind == INV]
            if invs:
                self.stages.append((INV, invs))
        sums = []
        for k, form in enumerate(outs):
            if name in IN_PLACE_ONLY and form.terms == {("x", k): 1}:
                continue                # in place: unchanged
            sums.append(Item(SUM, form, None, 0, ("d", k)))
        if sums:
            self.stages.append((SUM, sums))
        self._check()

    def _check(self) -> None:
        for kind, items in self.stages:
            assert all(it.kind == kind for it in items)
            for it in items:
                for form in (it.a, it.b):
                    if form is not None:
                        assert sum(abs(c) for c in form.terms.values()) \
                            <= MAX_WEIGHT, (self.name, form.terms)
        # dst may alias x: the outputs read x only at their own index,
        # and nothing before the outputs writes dst
        kind, outs = self.stages[-1]
        assert kind == SUM
        for it in outs:
            for (a, i) in it.a.terms:
                assert a != "x" or i == it.dst[1], (self.name, it.dst)

    def rounds(self) -> int:
        """Product rounds (an inverse is a stage of its own)."""
        return sum(-(-len(items) // G) for kind, items in self.stages
                   if kind in (MUL, SQR))

    def products(self) -> int:
        return sum(len(items) for kind, items in self.stages
                   if kind in (MUL, SQR))

    def squares(self) -> int:
        return sum(len(items) for kind, items in self.stages if kind == SQR)

    def inverses(self) -> int:
        return sum(len(items) for kind, items in self.stages if kind == INV)

    def evaluate(self, **args) -> list:
        """The outputs on plain ints: args {"x": [12 ints], ...}."""
        vals = {("k", i): v for i, v in enumerate(v for _, v in CONSTS)}
        for a, vs in args.items():
            for i, v in enumerate(vs):
                vals[(a, i)] = v % P
        # an in-place program leaves the outputs it does not write as x
        out = [vals.get(("x", i)) for i in range(self.n_out)]

        def form(f):
            return sum(c * vals[s] for s, c in f.terms.items()) % P
        for kind, items in self.stages:
            got = {}
            for it in items:
                a = form(it.a)
                if kind == MUL:
                    r = a * form(it.b)
                elif kind == SQR:
                    r = a * a
                elif kind == INV:
                    r = pow(a, -1, P) if a else 0
                else:
                    r = a
                got[it.dst] = r % P
            vals.update(got)
            for (a, i), v in got.items():
                if a == "d":
                    out[i] = v
        return out


PROGRAMS = {name: Program(name) for name in PROGRAM_DEFS}
PROGRAM_ORDER = list(PROGRAM_DEFS)


# --- what a lane runs (the kernels' control flow) --------------------------------

ABS_U = abs(host.U)
# the final exponentiation's steps (the kernels' final_exp_lane), each a
# program name; pow_u is 62 cyclotomic squares and a product a set bit
# below the top
POW_ABS_U = ([p for bit in range(ABS_U.bit_length() - 2, -1, -1)
                for p in (["f12_cyclotomic_sqr"]
                          + (["f12_mul"] if ABS_U >> bit & 1 else []))])
FINAL_EXP = (["f12_inv", "f12_conj", "f12_mul",
              "f12_frobenius", "f12_frobenius", "f12_mul"]
             + 3 * (POW_ABS_U + ["f12_conj"])
             # y0 = fp fp2 fp3
             + ["f12_frobenius", "f12_frobenius", "f12_mul", "f12_frobenius",
                "f12_mul"]
             # y1 = conj(f), y2, y3, y4, y5, y6
             + ["f12_conj", "f12_frobenius", "f12_frobenius",
                "f12_frobenius", "f12_conj", "f12_frobenius", "f12_mul",
                "f12_conj", "f12_conj", "f12_frobenius", "f12_mul",
                "f12_conj"]
             # the tail's products and squares
             + ["f12_cyclotomic_sqr", "f12_mul", "f12_mul", "f12_mul",
                "f12_mul", "f12_mul", "f12_cyclotomic_sqr", "f12_mul",
                "f12_cyclotomic_sqr", "f12_mul", "f12_mul",
                "f12_cyclotomic_sqr", "f12_mul"])


def lane_programs(is_add, kernel: str, check: bool = True) -> List[str]:
    """The programs one lane of `kernel` runs, in order (the Miller
    kernel: one schedule of len(is_add) main steps; its first square, of
    one, is skipped)."""
    if kernel == "fp256bn_miller":
        seq = ["g1_to_mont"]
        for s, add in enumerate(is_add):
            if not add and s > 0:
                seq.append("f12_sqr")
            seq.append("f12_mul_line")
        return seq + ["f12_conj", "f12_mul_line", "f12_mul_line",
                      "f12_from_mont"]
    if kernel == "fp256bn_final_exp":
        head = ["f12_to_mont"] * (2 if check else 1) + (
            ["f12_mul"] if check else [])
        return head + FINAL_EXP + ([] if check else ["f12_from_mont"])
    raise ValueError(f"unknown kernel {kernel}")


def design_counts(is_add, kernel: str, check: bool = True) -> dict:
    """Fp products (squares among them), Fp inverses and product rounds
    one lane (one group of G threads) of `kernel` runs under this design:
    its programs, plus the Miller lane's B x products (two a step, in
    rounds of G)."""
    seq = lane_programs(is_add, kernel, check)
    # an inverse ends with a product (into the Montgomery domain)
    products = sum(PROGRAMS[p].products() + PROGRAMS[p].inverses()
                   for p in seq)
    rounds = sum(PROGRAMS[p].rounds() for p in seq)
    if kernel == "fp256bn_miller":
        bx = 2 * (len(is_add) + 2)
        products += bx
        rounds += -(-bx // G)
    return {"products": products, "rounds": rounds,
            "squares": sum(PROGRAMS[p].squares() for p in seq),
            "inverses": sum(PROGRAMS[p].inverses() for p in seq)}


# --- the header -----------------------------------------------------------------

def _term(slot, coeff: int) -> int:
    a, i = slot
    assert 0 < abs(coeff) <= MAX_COEFF and 0 <= i < 512
    return (i | ARGS.index(a) << 9 | (coeff & 15) << 12)


def _terms(form: Lin) -> List[int]:
    out = []
    for slot, c in sorted(form.terms.items(),
                          key=lambda sc: (ARGS.index(sc[0][0]), sc[0][1])):
        while c:
            step = max(-MAX_COEFF, min(MAX_COEFF, c))
            out.append(_term(slot, step))
            c -= step
    return out


def kernel_temps(kernel: str) -> int:
    """The most products one program of `kernel` keeps."""
    names = set(lane_programs([False, True], kernel, True)
                + lane_programs([False, True], kernel, False))
    return max(PROGRAMS[n].n_temps for n in names)


def header() -> str:
    terms: List[int] = []
    items: List[Tuple[int, int, int, int, int]] = []
    stages: List[Tuple[int, int, int]] = []
    progs: List[Tuple[int, int]] = []
    for name in PROGRAM_ORDER:
        prog = PROGRAMS[name]
        progs.append((len(stages), len(prog.stages)))
        for kind, its in prog.stages:
            stages.append((len(items), len(its), kind))
            for it in its:
                ta = _terms(it.a)
                tb = _terms(it.b) if kind == MUL else []
                items.append((len(terms), len(ta), len(tb),
                              _term(it.dst, 1) & 0xFFF))
                terms.extend(ta + tb)
    max_temps = max(p.n_temps for p in PROGRAMS.values())
    lines = [
        "// GENERATED by `python -m fabric_mod_tpu_torch.ops.fp256bn_programs`",
        "// from the tower formulas there: do not edit.  The idemix pairing",
        "// kernels' Fp12 operations as programs of stages (fp256bn_pairing.cu",
        "// runs them).  A term is a slot and a coefficient: index (bits 0-8),",
        "// argument (bits 9-11: 0 the output, 1-4 the inputs x, y, z, w, 5 the",
        "// program's products, 6 the block's constants), signed coefficient",
        "// (bits 12-15).  An item's operand a is kBnTerms[first, first + na),",
        "// its operand b the nb terms after them, its output a slot (the",
        "// term's low 12 bits).",
        "",
        "#pragma once",
        "",
        "namespace {",
        "",
        "struct BnItem {",
        "    uint16_t first;",
        "    uint16_t n;              // na | nb << 8",
        "    uint16_t dst;",
        "};",
        "struct BnStage {",
        "    uint16_t first, count;   // items",
        "    uint16_t kind;",
        "};",
        "struct BnProgram {",
        "    uint16_t first, count;   // stages",
        "};",
        "",
        "enum BnKind : uint16_t { " + ", ".join(
            f"{k} = {i}" for i, k in enumerate(KIND_NAMES)) + " };",
        "enum BnProgramId : int {",
    ]
    for i, name in enumerate(PROGRAM_ORDER):
        cname = "kProg" + "".join(w.capitalize() for w in name.split("_"))
        lines.append(f"    {cname} = {i},")
    lines += [
        "};",
        "",
        "// threads a lane: a program's round has this many products (a",
        "// divisor of 32, so that a group never straddles two warps)",
        f"constexpr int kGroup = {G};",
        f"constexpr int kBnPrograms = {len(progs)};",
        f"constexpr int kBnStages = {len(stages)};",
        f"constexpr int kBnItems = {len(items)};",
        f"constexpr int kBnTerms = {len(terms)};",
        f"constexpr int kBnConsts = {len(CONSTS)};",
        "// a term that adds the zero constant: a form's padding",
        f"constexpr uint32_t kBnZeroTerm = 0x{_term(('k', CONST_INDEX['zero']), 1):04X}u;",
        "// the most products one program keeps (any, the Miller kernel's,",
        "// the final exponentiation's)",
        f"constexpr int kBnMaxTemps = {max_temps};",
        f"constexpr int kBnMillerTemps = {kernel_temps('fp256bn_miller')};",
        f"constexpr int kBnFinalExpTemps = {kernel_temps('fp256bn_final_exp')};",
        "",
        "// the block's constants: " + ", ".join(n for n, _ in CONSTS),
        "// (Montgomery form but for r2 and one, which are raw multipliers)",
        "__constant__ uint32_t kBnConstWords[kBnConsts][8] = {",
    ]
    for v in const_words():
        w = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
        lines.append("    {" + ", ".join(f"0x{x:08X}u" for x in w) + "},")
    lines += ["};", "", "__constant__ BnProgram kBnProgramTable[kBnPrograms] = {"]
    lines += [f"    {{{a}, {b}}}," for a, b in progs]
    lines += ["};", "", "__constant__ BnStage kBnStageTable[kBnStages] = {"]
    lines += [f"    {{{a}, {b}, {KIND_NAMES[k]}}}," for a, b, k in stages]
    lines += ["};", "", "__constant__ BnItem kBnItemTable[kBnItems] = {"]
    for i in range(0, len(items), 4):
        lines.append("    " + " ".join(
            f"{{{a}, {na | nb << 8}, 0x{d:03X}}}," for a, na, nb, d in
            items[i:i + 4]))
    lines += ["};", "", "__constant__ uint16_t kBnTermTable[kBnTerms] = {"]
    for i in range(0, len(terms), 10):
        lines.append("    " + " ".join(f"0x{t:04X}," for t in terms[i:i + 10]))
    lines += ["};", "", "}  // namespace", ""]
    return "\n".join(lines)


HEADER_PATH = Path(__file__).resolve().parents[1] / "csrc" / \
    "fp256bn_programs.cuh"


def main() -> int:
    HEADER_PATH.write_text(header())
    for name in PROGRAM_ORDER:
        p = PROGRAMS[name]
        print(f"{name}: {p.products()} products in {p.rounds()} rounds, "
              f"{p.inverses()} inverses, {len(p.stages)} stages, "
              f"{p.n_temps} temps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
