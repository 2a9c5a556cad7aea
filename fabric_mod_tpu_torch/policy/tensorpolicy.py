"""Whole-block tensor policy evaluation on the verify mask's device.

The port of fabric_mod_tpu/policy/tensorpolicy.py.  Every endorsement-
policy evaluation of a block becomes one row of dense tensors, and one
evaluator pass produces every verdict:

* ``TensorProgram`` / ``compile_tensor_program`` (copied) — a
  SignaturePolicyEnvelope rule tree flattened into a fixed op list
  (LEAF / LEAFC / ENTER / SAVE / COMMIT / THRESH) whose execution
  reproduces the closure compiler's greedy used-flag semantics exactly.
  Trees over the caps fall back to the closure path.
* ``PrincipalMemo`` (copied) — the principal-satisfaction matrix is
  computed via the MSP once per (identity, principal, config sequence).
* ``TensorSession`` (copied) — the per-block rows; ``attach_mask``
  binds the block's verify mask.

The evaluator itself, ``_step`` and ``eval_torch``, is written once over
torch tensors and runs on the device the mask lies on.  The reference
runs the same op semantics as a jitted ``lax.scan`` (``_jax_eval_fn``,
a device program but not a Pallas kernel); here it is plain torch ops,
one short sequence of launches per op of the longest program, and shapes
stay tight because eager torch compiles nothing per shape.  When the
verifier hands over a CUDA mask (bccsp/gpu.py's fused seam),
``attach_mask`` enqueues the whole pass behind the verify on the same
stream before any host sync; a numpy mask (a verifier that resolved on
the host) runs the same evaluator on the CPU (``eval_numpy``).
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch import device as _device

# ---------------------------------------------------------------------------
# Tensorizability caps (the reference's: a program that fits them means
# the same thing in both packages).  Anything larger falls back to the
# closure path.
# ---------------------------------------------------------------------------
MAX_IDENTS = 8          # identity slots per evaluation instance
MAX_PRINCIPALS = 8      # principals per policy envelope
MAX_DEPTH = 4           # NOutOf nesting depth (SAVE trial frames)
MAX_OPS = 64            # flattened program length
# NOutOf nodes legally sit at depths 0..MAX_DEPTH and each pushes a
# COUNTER, so the counter stack needs MAX_DEPTH+1 slots; SAVE frames
# share the sizing for one mask range
STACK_SLOTS = MAX_DEPTH + 1

# opcodes of the flattened program
OP_NOP = 0              # padding
OP_LEAF = 1             # arg = principal column: greedy first-unused pick
OP_ENTER = 2            # push a zero child-success counter
OP_SAVE = 3             # push a trial copy of the used flags
OP_COMMIT = 4           # pop trial: keep on child success, else restore
OP_THRESH = 5           # arg = n: result = (popped counter >= n)
OP_LEAFC = 6            # a leaf child: LEAF, and counter += success

# Evaluator passes by where the block's mask lay: "cuda" or "cpu" for a
# tensor from the verifier's fused seam, "host" for a numpy mask.
PASSES: "collections.Counter[str]" = collections.Counter()


def reset_counts() -> None:
    PASSES.clear()


def counts() -> dict:
    return dict(PASSES)


# ---------------------------------------------------------------------------
# Compilation: rule tree -> flat op program
# ---------------------------------------------------------------------------

class TensorProgram:
    """One SignaturePolicyEnvelope compiled to the flat op form.
    Immutable; shared by every evaluation instance of the policy."""

    __slots__ = ("ops", "args", "n_ops", "depth", "principals",
                 "principal_bytes")

    def __init__(self, ops: List[int], args: List[int], depth: int,
                 principals: Sequence):
        self.n_ops = len(ops)
        self.ops = np.asarray(ops, np.int32)
        self.args = np.asarray(args, np.int32)
        self.depth = depth
        self.principals = list(principals)
        self.principal_bytes = [p.encode() for p in self.principals]


def compile_tensor_program(envelope) -> Optional[TensorProgram]:
    """SignaturePolicyEnvelope -> TensorProgram, or None when the tree
    is non-tensorizable (over the caps, or malformed — malformed trees
    must keep failing through the closure compiler's own errors)."""
    rule = envelope.rule
    principals = envelope.identities
    if rule is None or len(principals) > MAX_PRINCIPALS:
        return None
    ops: List[int] = []
    args: List[int] = []
    depth = [0]

    def emit(node, d: int) -> bool:
        if d > MAX_DEPTH:
            return False
        depth[0] = max(depth[0], d)
        if node.n_out_of is not None:
            ops.append(OP_ENTER)
            args.append(0)
            for child in node.n_out_of.rules:
                if child.n_out_of is None:
                    idx = child.signed_by
                    if not 0 <= idx < len(principals):
                        return False  # the closure compiler raises here
                    ops.append(OP_LEAFC)
                    args.append(idx)
                    if len(ops) > MAX_OPS:
                        return False
                    continue
                ops.append(OP_SAVE)
                args.append(0)
                if not emit(child, d + 1):
                    return False
                ops.append(OP_COMMIT)
                args.append(0)
            n = int(node.n_out_of.n)
            if not -(1 << 31) <= n < (1 << 31):
                # outside the int32 args plane: the closure path
                # evaluates `verified >= n` for any n
                return False
            ops.append(OP_THRESH)
            args.append(n)
            return len(ops) <= MAX_OPS
        idx = node.signed_by
        if not 0 <= idx < len(principals):
            return False              # the closure compiler raises here
        ops.append(OP_LEAF)
        args.append(idx)
        return len(ops) <= MAX_OPS

    if not emit(rule, 0):
        return None
    return TensorProgram(ops, args, max(1, depth[0]), principals)


# ---------------------------------------------------------------------------
# Principal-satisfaction memo
# ---------------------------------------------------------------------------

class PrincipalMemo:
    """Bounded memo of msp.satisfies_principal verdicts keyed by
    (mspid, cert fingerprint, principal bytes, config sequence): one
    MSP cert-chain walk per unique pair per config epoch."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._d: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def usable(self, ident) -> bool:
        """The key is the x509 cert fingerprint; a cert-less identity
        cannot ride the tensors and its evaluation falls back."""
        return getattr(ident, "cert", None) is not None

    def satisfied(self, msp_mgr, ident, principal,
                  principal_bytes: bytes, seq: int) -> bool:
        # cached on the identity: the MSP cache hands back the same
        # Identity for repeated creator/endorser bytes
        fp = getattr(ident, "_fmt_cert_fp", None)
        if fp is None:
            from fabric_mod_tpu_torch.msp.identities import cert_fingerprint
            fp = cert_fingerprint(ident.cert)
            try:
                ident._fmt_cert_fp = fp
            except AttributeError:
                pass                      # slotted identity: no attr cache
        key = (ident.mspid, fp, principal_bytes, seq)
        with self._lock:
            got = self._d.get(key)
        if got is not None:
            self.hits += 1
            return got
        self.misses += 1
        val = bool(msp_mgr.satisfies_principal(ident, principal))
        with self._lock:
            if len(self._d) >= self.capacity:
                # overflow means key churn (config sequences advancing):
                # old epochs never hit again
                self._d.clear()
            self._d[key] = val
        return val

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


_MEMO_BY_MGR: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_MEMO_LOCK = threading.Lock()


def principal_memo_for(msp_mgr) -> PrincipalMemo:
    """One memo per MspManager (weak-keyed): a bundle swap (new
    manager) starts a fresh memo."""
    with _MEMO_LOCK:
        memo = _MEMO_BY_MGR.get(msp_mgr)
        if memo is None:
            memo = PrincipalMemo()
            _MEMO_BY_MGR[msp_mgr] = memo
        return memo


# ---------------------------------------------------------------------------
# The evaluator: one op-step semantics over torch tensors, on any device
# ---------------------------------------------------------------------------

def _step(state, opc, arg, sat_col, valid):
    """Execute op t for every instance at once.  Ops are exclusive per
    instance, so the per-op updates compose with where-masks; the
    semantics mirror cauthdsl._compile exactly:

      LEAF    the first unused valid identity satisfying the principal
              is consumed (the closure's in-order scan)
      SAVE    trial = list(used) before a child runs
      COMMIT  child failed -> used[:] = trial restored; succeeded ->
              keep mutations, count += 1 (no early exit either way)
      THRESH  verified >= n
    """
    used, ustack, usp, cstack, csp, result = state
    is_leafc = opc == OP_LEAFC
    is_leaf = (opc == OP_LEAF) | is_leafc
    is_enter = opc == OP_ENTER
    is_save = opc == OP_SAVE
    is_commit = opc == OP_COMMIT
    is_thresh = opc == OP_THRESH
    drange = torch.arange(ustack.shape[1], device=used.device)

    # LEAF / LEAFC: greedy first-unused pick — the first True of each
    # row (a running count of 1 at a True), no argmax tie rule involved
    avail = valid & ~used & sat_col
    found = avail.any(dim=1)
    pick = avail & (avail.cumsum(dim=1) == 1) & is_leaf[:, None]
    used = used | pick
    result = torch.where(is_leaf, found, result)

    # SAVE: push the trial copy at usp
    push = (drange[None, :] == usp[:, None]) & is_save[:, None]
    ustack = torch.where(push[:, :, None], used[:, None, :], ustack)
    usp = usp + is_save.to(usp.dtype)

    # COMMIT: pop the trial; restore on child failure; count a success
    top = drange[None, :] == (usp - 1)[:, None]
    saved = (ustack & top[:, :, None]).any(dim=1)
    restore = is_commit[:, None] & ~result[:, None]
    used = torch.where(restore, saved, used)
    usp = usp - is_commit.to(usp.dtype)
    ctop = drange[None, :] == (csp - 1)[:, None]
    # counter increments: a COMMIT whose child succeeded, or a fused
    # leaf child (LEAFC) that found an identity this step
    counted = (is_commit & result) | (is_leafc & found)
    cstack = cstack + (ctop & counted[:, None]).to(cstack.dtype)

    # ENTER: push a zero counter at csp
    cpush = (drange[None, :] == csp[:, None]) & is_enter[:, None]
    cstack = cstack.masked_fill(cpush, 0)
    csp = csp + is_enter.to(csp.dtype)

    # THRESH: verified >= n, pop the counter (ctop is this op's own
    # counter: thresh instances took no enter/commit branch this step)
    count_top = (cstack * ctop).sum(dim=1)
    result = torch.where(is_thresh, count_top >= arg, result)
    csp = csp - is_thresh.to(csp.dtype)
    return used, ustack, usp, cstack, csp, result


def eval_torch(valid: torch.Tensor, sat: torch.Tensor, ops: torch.Tensor,
               args: torch.Tensor, depth: int = STACK_SLOTS) -> torch.Tensor:
    """(N, I) bool valid, (N, I, P) bool sat, (N, T) int32 ops/args, all
    on one device -> (N,) bool verdicts on that device."""
    n, n_i = valid.shape
    dev = valid.device
    state = (torch.zeros((n, n_i), dtype=torch.bool, device=dev),
             torch.zeros((n, depth, n_i), dtype=torch.bool, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros((n, depth), dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.int32, device=dev),
             torch.zeros(n, dtype=torch.bool, device=dev))
    t_ops = ops.shape[1]
    # every op's principal column at once: (N, I, T)
    cols = args.clamp(0, sat.shape[2] - 1).to(torch.int64)
    sat_cols = torch.gather(sat, 2, cols[:, None, :].expand(n, n_i, t_ops))
    for t in range(t_ops):
        state = _step(state, ops[:, t], args[:, t], sat_cols[:, :, t], valid)
    return state[-1]


def eval_numpy(valid: np.ndarray, sat: np.ndarray, ops: np.ndarray,
               args: np.ndarray, depth: int = STACK_SLOTS) -> np.ndarray:
    """`eval_torch` on the CPU for numpy inputs and output — the
    host-mask path."""
    got = eval_torch(torch.from_numpy(np.ascontiguousarray(valid, bool)),
                     torch.from_numpy(np.ascontiguousarray(sat, bool)),
                     torch.from_numpy(np.ascontiguousarray(ops, np.int32)),
                     torch.from_numpy(np.ascontiguousarray(args, np.int32)),
                     depth)
    return got.numpy()


def _valid_numpy(mask: np.ndarray, gather, host_ok, present) -> np.ndarray:
    if mask.size:
        return np.where(gather >= 0,
                        mask[np.clip(gather, 0, mask.size - 1)],
                        host_ok) & present
    return host_ok & present


# ---------------------------------------------------------------------------
# The per-block session
# ---------------------------------------------------------------------------

class TensorPending:
    """The tensor path's PendingEval twin: `finish(mask)` reads the
    instance's verdict from the session's single evaluator pass."""

    __slots__ = ("_session", "_idx")

    def __init__(self, session: "TensorSession", idx: int):
        self._session = session
        self._idx = idx

    def finish(self, mask) -> bool:
        return self._session.verdict(self._idx)


class TensorSession:
    """All policy evaluations of one block as dense tensors.

    Lifecycle (driven by TxValidator):
      stage(...)    per prepared policy: register (program, identities,
                    verdict slots); returns a TensorPending or None
                    (non-tensorizable -> caller falls back to closures)
      finalize()    build the block tensors; the MSP principal matrix
                    is computed here
      attach_mask() bind the block's verify mask; a tensor mask has the
                    evaluator enqueued on its device at once, a numpy
                    mask defers to the CPU at verdicts()
      verdicts()    the (N,) verdict vector, computed exactly once
    """

    def __init__(self, msp_mgr, seq: int = 0,
                 memo: Optional[PrincipalMemo] = None):
        self._msp_mgr = msp_mgr
        self._seq = seq
        self._memo = memo if memo is not None else \
            principal_memo_for(msp_mgr)
        self._staged: List[Tuple[TensorProgram, list, list]] = []
        self._tensors = None
        self._mask: Optional[np.ndarray] = None
        self._lazy: Optional[torch.Tensor] = None
        self._events = None
        self._verdicts: Optional[np.ndarray] = None
        self.fallbacks = 0

    def __len__(self) -> int:
        return len(self._staged)

    # -- staging ---------------------------------------------------------
    def stage(self, program: Optional[TensorProgram], idents: list,
              slots: list) -> Optional[TensorPending]:
        """Register one policy evaluation.  None (counted in
        `fallbacks`) when it cannot ride the tensors — the caller keeps
        its closure PendingEval."""
        if (program is None or len(idents) > MAX_IDENTS
                or not all(self._memo.usable(i) for i in idents)):
            self.fallbacks += 1
            return None
        idx = len(self._staged)
        self._staged.append((program, idents, slots))
        return TensorPending(self, idx)

    # -- tensor build ----------------------------------------------------
    def finalize(self) -> None:
        if self._tensors is not None or not self._staged:
            return
        n = len(self._staged)
        n_i = max(1, max(len(idents) for _p, idents, _s in self._staged))
        n_p = max(1, max(len(p.principals)
                         for p, _i, _s in self._staged))
        n_t = max(1, max(p.n_ops for p, _i, _s in self._staged))
        gather = np.full((n, n_i), -1, np.int32)
        host_ok = np.zeros((n, n_i), bool)
        present = np.zeros((n, n_i), bool)
        sat = np.zeros((n, n_i, n_p), bool)
        ops = np.zeros((n, n_t), np.int32)
        args = np.zeros((n, n_t), np.int32)
        memo, mgr, seq = self._memo, self._msp_mgr, self._seq
        # block-local probe cache: a 1000-tx block re-asks the same few
        # (identity, principal) pairs thousands of times
        local: dict = {}
        for row, (prog, idents, slots) in enumerate(self._staged):
            ops[row, :prog.n_ops] = prog.ops
            args[row, :prog.n_ops] = prog.args
            for i, (ident, (bidx, hok)) in enumerate(zip(idents, slots)):
                present[row, i] = True
                if bidx is not None:
                    gather[row, i] = bidx
                else:
                    host_ok[row, i] = bool(hok)
                for p, (principal, pbytes) in enumerate(
                        zip(prog.principals, prog.principal_bytes)):
                    lkey = (id(ident), pbytes)
                    got = local.get(lkey)
                    if got is None:
                        got = memo.satisfied(mgr, ident, principal,
                                             pbytes, seq)
                        local[lkey] = got
                    if got:
                        sat[row, i, p] = True
        self._tensors = (gather, host_ok, present, sat, ops, args)

    # -- mask binding + evaluation ---------------------------------------
    def attach_mask(self, raw) -> None:
        """Bind the block's verify mask: a torch tensor (the verifier's
        fused seam — the evaluator is enqueued on its device here,
        before the validator's host sync) or a numpy array (evaluated
        on the CPU at verdicts())."""
        if self._verdicts is not None or self._lazy is not None \
                or not self._staged:
            return
        self.finalize()
        if not isinstance(raw, torch.Tensor):
            self._mask = np.asarray(raw, bool)
            return
        dev = raw.device
        PASSES[dev.type] += 1
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)

        # non-blocking uploads: they queue behind the verify instead of
        # waiting for it on the host
        gather, host_ok, present, sat, ops, args = (
            _device.upload(a, dev) for a in self._tensors)
        mask = raw.to(torch.bool)
        if mask.numel():
            valid = torch.where(
                gather >= 0,
                mask[gather.clamp(0, mask.numel() - 1).to(torch.int64)],
                host_ok) & present
        else:
            valid = host_ok & present
        self._lazy = eval_torch(valid, sat, ops, args)
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(dev))

    def device_ms(self) -> Optional[float]:
        """Device time between the evaluator's first and last launch
        (CUDA events), after verdicts(); None unless the mask was on a
        CUDA device."""
        if self._events is None or self._verdicts is None:
            return None
        return self._events[0].elapsed_time(self._events[1])

    def verdicts(self) -> np.ndarray:
        """The (N,) verdict vector; computed exactly once."""
        if self._verdicts is not None:
            return self._verdicts
        if not self._staged:
            self._verdicts = np.zeros(0, bool)
            return self._verdicts
        if self._lazy is not None:
            self._verdicts = self._lazy.cpu().numpy()
        else:
            if self._mask is None:
                raise RuntimeError(
                    "tensor session evaluated before its verify mask "
                    "was attached (resolve_mask must run first)")
            PASSES["host"] += 1
            gather, host_ok, present, sat, ops, args = self._tensors
            valid = _valid_numpy(self._mask, gather, host_ok, present)
            self._verdicts = eval_numpy(valid, sat, ops, args)
        return self._verdicts

    def verdict(self, idx: int) -> bool:
        return bool(self.verdicts()[idx])
