"""The port's policy engine against the JAX reference: DSL bytes, closure
verdicts, tensor programs, and the torch tensor-policy evaluator (on the
CPU) against the reference's numpy interpreter and its jitted XLA
program, on seeded programs up to the tensorizability caps.  Exact."""
import random

import numpy as np
import pytest
import torch

from fabric_mod_tpu.policy import cauthdsl as jcauthdsl
from fabric_mod_tpu.policy import policydsl as jpolicydsl
from fabric_mod_tpu.policy import tensorpolicy as jtp
from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch.policy import cauthdsl, policydsl
from fabric_mod_tpu_torch.policy import tensorpolicy as tp
from fabric_mod_tpu_torch.protos import messages as m

DSL = [
    "OutOf(2, 'Org1.peer', 'Org2.peer', 'Org3.peer')",
    "AND('Org1.member', OR('Org2.admin', 'Org3.client'))",
    "'Org3.peer'",
    "OR('A.member', 'A.member', 'B.orderer')",
    "outof(1, AND('A.peer', 'B.peer'), OutOf(2, 'C.admin', 'D.member', 'A.peer'))",
]


@pytest.mark.parametrize("text", DSL)
def test_dsl_bytes_equal(text):
    assert policydsl.from_string(text).encode() == \
        jpolicydsl.from_string(text).encode()


def test_dsl_errors_agree():
    for bad in ("AND(", "'Org1'", "OutOf(4, 'A.peer')", "'A.king'"):
        with pytest.raises(Exception) as got:
            policydsl.from_string(bad)
        with pytest.raises(Exception) as want:
            jpolicydsl.from_string(bad)
        assert type(got.value).__name__ == type(want.value).__name__


class FakeIdent:
    def __init__(self, key):
        self.key = key
        self.mspid = "fake"
        self.cert = None


class FakeMgr:
    """satisfies_principal from a (ident key, principal byte) table."""

    def __init__(self, table):
        self.table = table

    def satisfies_principal(self, ident, principal):
        return self.table.get((ident.key, principal.principal[0]), False)


def _rand_tree(rng, n_prins, mod, depth=0, max_depth=tp.MAX_DEPTH):
    """A random rule tree of `mod`'s messages; depth may pass the cap
    so the caps' edges are generated too."""
    if depth > max_depth or rng.random() < 0.4:
        return mod.SignaturePolicy(signed_by=rng.randrange(n_prins))
    k = rng.randrange(1, 4)
    subs = [_rand_tree(rng, n_prins, mod, depth + 1, max_depth)
            for _ in range(k)]
    return mod.SignaturePolicy(n_out_of=mod.NOutOf(
        n=rng.randrange(0, k + 2), rules=subs))


def _envelope(rule_bytes, n_prins, mod):
    """The same envelope in `mod`'s messages (decoded from one encoding,
    so both packages hold the same tree)."""
    rule = mod.SignaturePolicy.decode(rule_bytes)
    prins = [mod.MSPPrincipal(principal_classification=1,
                              principal=bytes([j])) for j in range(n_prins)]
    return mod.SignaturePolicyEnvelope(rule=rule, identities=prins)


def _pair_envelopes(rng, max_depth=tp.MAX_DEPTH):
    n_prins = rng.randrange(1, tp.MAX_PRINCIPALS + 2)
    rule = _rand_tree(rng, n_prins, m, max_depth=max_depth).encode()
    return _envelope(rule, n_prins, m), _envelope(rule, n_prins, jm), n_prins


def test_tensor_programs_equal():
    """compile_tensor_program: the same ops and args, and the same
    refusals (over the caps) on 600 seeded trees."""
    rng = random.Random(20261016)
    refused = 0
    for _ in range(600):
        env, jenv, _n = _pair_envelopes(rng, max_depth=tp.MAX_DEPTH + 1)
        got, want = tp.compile_tensor_program(env), \
            jtp.compile_tensor_program(jenv)
        assert (got is None) == (want is None)
        if got is None:
            refused += 1
            continue
        assert got.ops.tolist() == want.ops.tolist()
        assert got.args.tolist() == want.args.tolist()
        assert got.depth == want.depth
        assert got.principal_bytes == want.principal_bytes
    assert 0 < refused < 600
    assert (tp.MAX_IDENTS, tp.MAX_PRINCIPALS, tp.MAX_DEPTH, tp.MAX_OPS,
            tp.STACK_SLOTS) == (jtp.MAX_IDENTS, jtp.MAX_PRINCIPALS,
                                jtp.MAX_DEPTH, jtp.MAX_OPS, jtp.STACK_SLOTS)


def test_closure_verdicts_equal():
    """The compiled closures of both packages over the same identities,
    satisfaction table and valid flags."""
    rng = random.Random(7)
    for _ in range(400):
        env, jenv, n_prins = _pair_envelopes(rng)
        n_id = rng.randrange(0, 7)
        idents = [FakeIdent(i) for i in range(n_id)]
        mgr = FakeMgr({(i, j): rng.random() < 0.5
                       for i in range(n_id) for j in range(n_prins)})
        valid = [i for i in idents if rng.random() < 0.7]
        got = cauthdsl._compile(env.rule, env.identities, mgr)(
            list(valid), [False] * len(valid))
        want = jcauthdsl._compile(jenv.rule, jenv.identities, mgr)(
            list(valid), [False] * len(valid))
        assert got == want


def _random_batch(seed, n_inst, n_i, n_p, programs):
    """Dense evaluator inputs at the given widths: programs padded with
    NOPs to the longest, random valid / satisfaction planes."""
    rng = np.random.default_rng(seed)
    n_t = max(p.n_ops for p in programs)
    ops = np.zeros((n_inst, n_t), np.int32)
    args = np.zeros((n_inst, n_t), np.int32)
    for row in range(n_inst):
        p = programs[row % len(programs)]
        ops[row, :p.n_ops] = p.ops
        args[row, :p.n_ops] = p.args
    valid = rng.random((n_inst, n_i)) < 0.7
    sat = rng.random((n_inst, n_i, n_p)) < 0.5
    return valid, sat, ops, args


def _programs(seed, count):
    rng = random.Random(seed)
    out = []
    while len(out) < count:
        env, _jenv, _n = _pair_envelopes(rng)
        prog = tp.compile_tensor_program(env)
        if prog is not None:
            out.append(prog)
    # programs at the caps: the deepest nesting, the longest program
    deep = m.SignaturePolicy(signed_by=0)
    for d in range(tp.MAX_DEPTH):
        deep = m.SignaturePolicy(n_out_of=m.NOutOf(
            n=1, rules=[deep, m.SignaturePolicy(signed_by=d % 8)]))
    wide = m.SignaturePolicy(n_out_of=m.NOutOf(
        n=5, rules=[m.SignaturePolicy(signed_by=j % tp.MAX_PRINCIPALS)
                    for j in range(tp.MAX_OPS - 2)]))
    prins = [m.MSPPrincipal(principal_classification=1, principal=bytes([j]))
             for j in range(tp.MAX_PRINCIPALS)]
    for rule in (deep, wide):
        prog = tp.compile_tensor_program(
            m.SignaturePolicyEnvelope(rule=rule, identities=prins))
        assert prog is not None
        out.append(prog)
    assert max(p.n_ops for p in out) == tp.MAX_OPS
    assert max(p.depth for p in out) == tp.MAX_DEPTH
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_torch_evaluator_equals_numpy_reference(seed):
    """eval_torch on the CPU == the reference's eval_numpy, at
    MAX_IDENTS identities and MAX_PRINCIPALS principals."""
    progs = _programs(seed, 40)
    valid, sat, ops, args = _random_batch(
        seed, 300, tp.MAX_IDENTS, tp.MAX_PRINCIPALS, progs)
    want = jtp.eval_numpy(valid, sat, ops, args)
    got = tp.eval_torch(torch.from_numpy(valid), torch.from_numpy(sat),
                        torch.from_numpy(ops), torch.from_numpy(args))
    assert got.dtype == torch.bool
    assert got.numpy().tolist() == want.tolist()
    assert tp.eval_numpy(valid, sat, ops, args).tolist() == want.tolist()


def test_torch_evaluator_equals_jitted_reference():
    """The whole device pass — mask gather, host verdict slots, absent
    slots, the op program — against the reference's jitted XLA program
    (`_jax_eval_fn`, run on the JAX CPU backend)."""
    import jax.numpy as jnp
    progs = _programs(11, 30)
    n, n_i, n_p = 200, tp.MAX_IDENTS, tp.MAX_PRINCIPALS
    _valid, sat, ops, args = _random_batch(11, n, n_i, n_p, progs)
    rng = np.random.default_rng(12)
    mask = rng.random(700) < 0.6
    gather = np.where(rng.random((n, n_i)) < 0.8,
                      rng.integers(0, 700, (n, n_i)), -1).astype(np.int32)
    host_ok = rng.random((n, n_i)) < 0.5
    present = rng.random((n, n_i)) < 0.85
    want = np.asarray(jtp._jax_eval_fn()(
        jnp.asarray(mask), jnp.asarray(gather), jnp.asarray(host_ok),
        jnp.asarray(present), jnp.asarray(sat),
        jnp.asarray(np.ascontiguousarray(ops.T)),
        jnp.asarray(np.ascontiguousarray(args.T))))
    valid = tp._valid_numpy(mask, gather, host_ok, present)
    got = tp.eval_numpy(valid, sat, ops, args)
    assert got.tolist() == want.tolist()


class TableMemo:
    """Satisfaction keyed by (ident key, principal bytes), shared by the
    sessions of both packages."""

    def __init__(self):
        self._rng = random.Random(5)
        self._t = {}

    def usable(self, ident):
        return True

    def satisfied(self, mgr, ident, principal, pbytes, seq):
        key = (ident.key, pbytes)
        if key not in self._t:
            self._t[key] = self._rng.random() < 0.5
        return self._t[key]


def test_session_tensor_mask_equals_reference_session():
    """A TensorSession fed a CPU tensor mask (the fused seam's form)
    gives the reference session's verdicts on a numpy mask, and counts
    one pass on the mask's device."""
    rng = random.Random(99)
    progs = []
    while len(progs) < 25:
        env, jenv, _n = _pair_envelopes(rng)
        p, jp = tp.compile_tensor_program(env), \
            jtp.compile_tensor_program(jenv)
        if p is not None:
            progs.append((p, jp))
    mask = np.asarray([rng.random() < 0.6 for _ in range(50)], bool)
    staged = []
    for p, jp in progs:
        k = rng.randrange(0, tp.MAX_IDENTS + 1)
        idents = [FakeIdent((len(staged), i)) for i in range(k)]
        slots = [(rng.randrange(50), False) if rng.random() < 0.8
                 else (None, rng.random() < 0.5) for _ in range(k)]
        staged.append((p, jp, idents, slots))
    memo = TableMemo()
    ref = jtp.TensorSession(FakeMgr({}), memo=memo)
    port = tp.TensorSession(FakeMgr({}), memo=memo)
    for p, jp, idents, slots in staged:
        assert ref.stage(jp, idents, slots) is not None
        assert port.stage(p, idents, slots) is not None
    ref.attach_mask(mask)
    tp.reset_counts()
    port.attach_mask(torch.from_numpy(mask))
    assert port.verdicts().tolist() == ref.verdicts().tolist()
    assert tp.counts() == {"cpu": 1}
