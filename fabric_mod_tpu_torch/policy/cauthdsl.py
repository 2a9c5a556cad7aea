"""Signature-policy compilation and batch-first evaluation.

The port's copy of fabric_mod_tpu/policy/cauthdsl.py.  The L2 core
(reference: common/cauthdsl/cauthdsl.go:24-92 `compile`,
common/cauthdsl/policy.go:87 `EvaluateSignedData`, and
common/policies/policy.go:365-403 `SignatureSetToValidIdentities`).

The reference's evaluation shape is already ideal for a device batch:
it *first* deduplicates identities and eagerly verifies every
signature, *then* runs the combinatorial NOutOf/SignedBy walk over the
set of validated identities.  Here that split is explicit and
two-phase so a block validator can gather the signature sets of every
policy evaluation in a block, fire ONE device batch-verify, and only
then finish each policy decision host-side:

    collector = BatchCollector()
    pending = [pol.prepare(sds, collector) for (pol, sds) in work]
    mask = verifier.verify_many(collector.items)   # one device call
    results = [p.finish(mask) for p in pending]

`CompiledPolicy.evaluate_signed_data` is the standalone convenience
that does all three steps with a single verify call of its own.

Host-side work stays host-side: identity deserialization, cert-chain
validation, and principal matching are pointer-chasing x509 logic the
MSP (with its second-chance caches) already handles; only the ECDSA
math rides the batch.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from fabric_mod_tpu_torch.bccsp.api import VerifyItem
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos.protoutil import SignedData


class PolicyError(Exception):
    pass


class BatchCollector:
    """Accumulates VerifyItems across many policy evaluations so they
    can be verified in one device dispatch.  Identical work items
    (same digest, signature, key) dedup to one batch slot — meta
    policies hand the same signature set to every sub-policy, and
    re-verifying it per sub-policy would multiply the device batch."""

    def __init__(self):
        self.items: List[VerifyItem] = []
        self.requests = 0          # add() calls incl. dedup hits — the
        self._index: dict = {}     # spread vs len(items) is staged work
        #                            the dedup saved (validator metrics)

    def add(self, item: VerifyItem) -> int:
        self.requests += 1
        # message MUST be part of the key: two raw-message items
        # share digest=b"" — deduping on
        # (digest, sig, key) alone would let a replayed signature over
        # a DIFFERENT message share the valid item's verdict slot
        key = (item.digest, item.signature, item.public_xy,
               getattr(item, "message", None))
        got = self._index.get(key)
        if got is not None:
            return got
        self.items.append(item)
        idx = len(self.items) - 1
        self._index[key] = idx
        return idx


class PendingEval:
    """A policy decision waiting on the device verdict mask.

    `slots` pairs each candidate identity with either the index of its
    VerifyItem in the collector batch or a host-computed verdict (for
    non-batchable curves).
    """

    def __init__(self, closure: Callable, idents: List,
                 slots: List[tuple]):
        self._closure = closure
        self._idents = idents
        self._slots = slots                 # (batch_idx | None, host_ok)

    def finish(self, mask) -> bool:
        """Resolve against the batch verdict mask -> policy verdict."""
        valid = []
        for ident, (bidx, host_ok) in zip(self._idents, self._slots):
            ok = bool(mask[bidx]) if bidx is not None else host_ok
            if ok:
                valid.append(ident)
        used = [False] * len(valid)
        return self._closure(valid, used)


def _compile(rule: m.SignaturePolicy,
             principals: Sequence[m.MSPPrincipal],
             msp_mgr) -> Callable:
    """SignaturePolicy proto tree -> closure(idents, used) -> bool
    (reference: cauthdsl.go:24-92 — same greedy used-flag semantics)."""
    if rule.n_out_of is not None:
        n = rule.n_out_of.n
        subs = [_compile(r, principals, msp_mgr) for r in rule.n_out_of.rules]

        def node(idents, used) -> bool:
            # Trial/commit used-flag discipline, no early exit — exactly
            # the reference's loop (cauthdsl.go:45-60): a failed child
            # must not consume identities, and later children still run
            # so the committed used-set matches the reference's.
            verified = 0
            for sub in subs:
                trial = list(used)
                if sub(idents, trial):
                    verified += 1
                    used[:] = trial
            return verified >= n
        return node

    idx = rule.signed_by
    if not 0 <= idx < len(principals):
        raise PolicyError(f"identity index {idx} out of range")
    principal = principals[idx]

    def leaf(idents, used) -> bool:
        for i, ident in enumerate(idents):
            if used[i]:
                continue
            if msp_mgr.satisfies_principal(ident, principal):
                used[i] = True
                return True
        return False
    return leaf


class CompiledPolicy:
    """A compiled SignaturePolicyEnvelope bound to an MSP manager.

    (reference: cauthdsl/policy.go `policy` + the provider at :25)
    """

    # sentinel: tensor compilation not attempted yet (None is a valid
    # outcome meaning "non-tensorizable")
    _TENSOR_UNSET = object()

    def __init__(self, envelope: m.SignaturePolicyEnvelope, msp_mgr):
        if envelope.rule is None:
            raise PolicyError("policy envelope has no rule")
        self._msp_mgr = msp_mgr
        self._closure = _compile(envelope.rule, envelope.identities, msp_mgr)
        self.envelope = envelope
        self._tensor = CompiledPolicy._TENSOR_UNSET

    def tensor_program(self):
        """The policy's flattened tensor form (policy/tensorpolicy.py),
        compiled once and cached; None when the tree is
        non-tensorizable (over the caps) and evaluations must stay on
        the closure path."""
        if self._tensor is CompiledPolicy._TENSOR_UNSET:
            from fabric_mod_tpu_torch.policy.tensorpolicy import (
                compile_tensor_program)
            self._tensor = compile_tensor_program(self.envelope)
        return self._tensor

    # -- phase 1: dedup + validate + stage verifies ----------------------
    def prepare(self, signed_datas: Sequence[SignedData],
                collector: BatchCollector, session=None):
        """Dedup identities, drop undeserializable/invalid ones, stage
        each survivor's signature check into `collector` (reference:
        common/policies/policy.go:365-403, which dedups then verifies
        every signature before the policy walk).

        With a `session` (policy/tensorpolicy.TensorSession) the
        evaluation registers as one row of the block's dense tensors
        and the returned pending resolves from the session's single
        whole-block evaluator pass; without one (or when this policy
        is non-tensorizable) the classic closure PendingEval comes
        back — verdicts are identical either way."""
        idents: List = []
        slots: List[tuple] = []
        seen = set()
        for sd in signed_datas:
            if sd.identity in seen:
                continue                      # duplicate identity: skip
            seen.add(sd.identity)
            try:
                ident = self._msp_mgr.deserialize_identity(sd.identity)
            except Exception:
                continue                      # unknown MSP / bad cert
            try:
                self._msp_mgr.validate(ident)
            except Exception:
                continue                      # expired/revoked/untrusted
            item = ident.verify_item(sd.data, sd.signature)
            if item is not None:
                slots.append((collector.add(item), False))
            else:                             # non-P256: host verify now
                slots.append((None, ident.verify(sd.data, sd.signature)))
            idents.append(ident)
        if session is not None:
            pending = session.stage(self.tensor_program(), idents, slots)
            if pending is not None:
                return pending
        return PendingEval(self._closure, idents, slots)

    def satisfied_by_principals(self, idents: Sequence) -> bool:
        """Principal-only evaluation — no signatures involved (the
        reference's AccessFilter use: is this SET OF IDENTITIES inside
        the policy, e.g. collection membership checks at private-data
        dissemination time)."""
        used = [False] * len(idents)
        return self._closure(list(idents), used)

    # -- phases 1+2+3 standalone -----------------------------------------
    def evaluate_signed_data(self, signed_datas: Sequence[SignedData],
                             verify_many: Optional[Callable] = None) -> bool:
        """One-shot evaluation with its own single batch dispatch.
        `verify_many` defaults to the software verifier."""
        if verify_many is None:
            from fabric_mod_tpu_torch.bccsp.sw import SwVerifier
            verify_many = SwVerifier().verify_many
        collector = BatchCollector()
        pending = self.prepare(signed_datas, collector)
        return pending.finish(verify_many(collector.items))
