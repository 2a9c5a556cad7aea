"""Block validation: one device batch per block — the port of
fabric_mod_tpu/peer/txvalidator.py.

(reference: core/committer/txvalidator/v20/validator.go:182-267
`TxValidator.Validate` + `ValidateTx` at :300-455,
core/common/validation/msgvalidation.go:248 `ValidateTransaction`, the
plugin dispatcher at plugindispatcher/dispatcher.go:102, the default
VSCC at handlers/validation/builtin/v20/validation_logic.go:185, and
the endorsement signature-set construction at
statebased/validator_keylevel.go:245-258.)

  pass 1 (host)   unpack every tx; syntactic checks; creator identity
                  validation; stage the creator signature and every
                  endorsement signature of every tx into ONE
                  BatchCollector
  pass 2 (device) the verifier's batch verify over the collector's
                  items (bccsp/gpu.py: the CUDA ladder kernels)
  pass 3          with `tensor_policy`, one evaluator pass over the
                  verify mask on its device (policy/tensorpolicy.py);
                  then, on the host, in block order: creator verdicts,
                  each endorsement-policy decision, duplicate tx ids,
                  key-level VALIDATION_PARAMETER overrides, the txflags

Staging runs the reference's two batch pre-passes over the whole block
(protos/batchdecode.py): the envelope spine in one vectorized scan, then
every spine-accepted endorser tx's body in one columnar decode.  A tx
both scans accepted is staged from the decoded values; a row the
scanner could not prove clean takes the generic per-tx decode
(`_written_groups`) with identical outcomes.  The columnar decode
rides on the StagedBlock (`rwsets`) to the ledger's commit
(ledger/kvledger.py), which reuses its tx ids and, with vector MVCC,
its planes; `Committer` composes the three.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch.ledger.rwsetutil import parse_tx_rwset
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS
from fabric_mod_tpu_torch.peer.plugins import PluginRegistry
from fabric_mod_tpu_torch.policy import BatchCollector
from fabric_mod_tpu_torch.policy import tensorpolicy
from fabric_mod_tpu_torch.protos import batchdecode
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.protos.protoutil import SignedData

V = m.TxValidationCode

VALIDATION_PARAMETER = "VALIDATION_PARAMETER"


class ValidationInfoProvider:
    """Resolves a chaincode namespace to its validation plugin and
    endorsement policy (reference: plugindispatcher dispatcher.go:102 +
    lifecycle ValidationInfo): a static map with a default."""

    def __init__(self, default_policy: bytes,
                 per_namespace: Optional[Dict[str, bytes]] = None):
        self._default = default_policy
        self._per_ns = dict(per_namespace or {})

    def validation_info(self, ns: str) -> Tuple[str, bytes]:
        return "vscc", self._per_ns.get(ns, self._default)

    def set_policy(self, ns: str, policy_bytes: bytes) -> None:
        self._per_ns[ns] = policy_bytes


class _KeyEval:
    """One written key's endorsement-policy resolution candidates
    (reference: statebased/validator_keylevel.go:243-271 — which
    VALIDATION_PARAMETER is in force can depend on EARLIER txs in the
    same block, so every candidate is staged in pass 1 and the choice
    is resolved in order in pass 3)."""

    __slots__ = ("ns", "key", "committed", "inblock")

    def __init__(self, ns: str, key: str, committed, inblock):
        self.ns = ns
        self.key = key
        self.committed = committed        # PendingEval | None
        self.inblock = inblock            # [(tx_idx, PendingEval)]


class _ActionEval:
    __slots__ = ("cc_pending", "key_evals")

    def __init__(self, cc_pending, key_evals):
        self.cc_pending = cc_pending      # chaincode-wide policy
        self.key_evals = key_evals        # [_KeyEval]


class _TxWork:
    """Per-tx staging between the host pass and the device verdict."""

    __slots__ = ("flag", "txid", "creator_slot", "actions", "is_config",
                 "env", "vp_writes", "written_ns")

    def __init__(self):
        self.flag = V.NOT_VALIDATED
        self.txid = ""
        self.creator_slot = None          # (batch_idx | None, host_ok)
        self.actions = []                 # [_ActionEval]
        self.is_config = False
        self.env = None                   # kept only for config txs
        self.vp_writes = []               # [(ns, key, policy_bytes)]
        self.written_ns = set()           # namespaces this tx writes


def _host_mask(raw) -> np.ndarray:
    """The verify mask as a host numpy array (a device tensor is copied
    back with .cpu(), which waits for the device)."""
    if isinstance(raw, torch.Tensor):
        return raw.cpu().numpy().astype(bool, copy=False)
    return np.asarray(raw, bool)


def _written_groups(results: bytes) -> list:
    """The generic decode of an action's rwset bytes into its written
    view per namespace occurrence, as batchdecode.TxBody.groups holds
    it: [(ns, [write keys], [(metadata key, [(name, value)])])].  Bytes
    that do not decode give no view (no key-level evals); a malformed
    inner rwset raises."""
    try:
        rwset = m.TxReadWriteSet.decode(results)
    except Exception:
        return []
    return [(ns, [w.key for w in kv.writes],
             [(mw.key, [(e.name, e.value) for e in mw.entries])
              for mw in kv.metadata_writes])
            for ns, kv in parse_tx_rwset(rwset)]


class StagedBlock:
    """A block after passes 1+2: host staging done, device batch
    dispatched, verdicts pending (resolved by TxValidator.finish).
    `session` (tensor_policy only) is the block's tensor-policy
    session: resolve_mask hands it the verify mask before the host
    sync, so a device mask flows straight into the evaluator.  `rwsets`
    is the block's columnar body decode (batchdecode.BlockRWSets, None
    for blocks under 4 rows) for the ledger's commit; `spine_fallbacks`
    counts the rows the spine scan left to the generic decode, and
    `decode_secs` is the host time of the two batch pre-passes.
    `trace_timeline` carries the block's tracing timeline from the
    commit pipe's stage loop to its commit loop (None disarmed)."""

    __slots__ = ("block", "validator", "works", "mask_fn", "_mask",
                 "session", "rwsets", "spine_fallbacks", "decode_secs",
                 "trace_timeline")

    def __init__(self, block, validator, works, mask_fn, session=None,
                 rwsets=None, spine_fallbacks=0, decode_secs=0.0):
        self.block = block
        self.validator = validator
        self.works = works
        self.mask_fn = mask_fn
        self._mask = None
        self.session = session
        self.rwsets = rwsets
        self.spine_fallbacks = spine_fallbacks
        self.decode_secs = decode_secs
        self.trace_timeline = None

    def resolve_mask(self) -> np.ndarray:
        """Await the device verdicts (idempotent).  The one choke point
        of the pipelined and the synchronous path: the verdict_await
        sub-stage is attributed here (reference :185)."""
        if self._mask is None:
            with tracing.span("verdict_await",
                              block=self.block.header.number):
                raw = self.mask_fn()
                if self.session is not None:
                    # bind (and, on a device mask, enqueue) the
                    # whole-block policy evaluator before the host sync
                    self.session.attach_mask(raw)
                self._mask = _host_mask(raw)
                # the fused verify seam defers its verdict-cache
                # write-back to the consumer's sync point — this is it
                writeback = getattr(self.mask_fn, "writeback", None)
                if writeback is not None:
                    writeback()
        return self._mask

    @property
    def needs_barrier(self) -> bool:
        """True when the NEXT block's staging must wait for this
        block's commit: config txs, VALIDATION_PARAMETER writes and
        lifecycle-namespace writes all change state pass 1 reads."""
        for w in self.works:
            if w.is_config or w.vp_writes or LIFECYCLE_NS in w.written_ns:
                return True
        return False


class TxValidator:
    """(reference: txvalidator/v20/validator.go TxValidator)

    `tensor_policy` evaluates every endorsement policy of a block in
    one tensor pass on the verify mask's device (the reference gates
    this with FABRIC_MOD_TPU_TENSOR_POLICY); off, each decision runs its
    compiled closure on the host.  Verdicts are identical either way."""

    def __init__(self, channel_id: str, msp_mgr, policy_eval, verifier,
                 vinfo: ValidationInfoProvider,
                 tx_id_exists: Optional[Callable[[str], bool]] = None,
                 config_apply: Optional[Callable[[m.Envelope], None]] = None,
                 state_metadata: Optional[Callable[[str, str],
                                                   Optional[bytes]]] = None,
                 plugin_registry: Optional[PluginRegistry] = None,
                 config_sequence: int = 0,
                 tensor_policy: bool = False):
        self.channel_id = channel_id
        self._msp_mgr = msp_mgr
        self._policy_eval = policy_eval
        self._verifier = verifier
        self._vinfo = vinfo
        # keys the tensor-policy principal memo: a config update can
        # never be answered from a previous epoch's principal matrix
        self._config_seq = config_sequence
        self._tensor_policy = tensor_policy
        # named validation plugins; an unknown name fails closed
        self._plugins = plugin_registry or PluginRegistry()
        self._tx_id_exists = tx_id_exists or (lambda _txid: False)
        # CONFIG txs are validated and applied through the channel
        # config machinery (reference: validator.go:400-421); with no
        # applier wired they fail closed
        self._config_apply = config_apply
        # committed VALIDATION_PARAMETER reader for key-level policies:
        # (ns, key) -> ApplicationPolicy bytes or None
        self._state_metadata = state_metadata

    # -- pass 1: host unpack + staging -----------------------------------
    def _stage_tx(self, env: m.Envelope, work: _TxWork,
                  collector: BatchCollector, inblock_vp,
                  session=None, spine=None, body=None) -> None:
        """Syntactic validation + creator/endorsement staging for one
        tx.  Sets work.flag on terminal failure, else leaves it pending
        the device verdicts (reference: msgvalidation.go:248).
        `spine` (batchdecode.SpineRow) is the batch pre-pass's decoded
        payload and headers, `body` (batchdecode.TxBody) its decoded
        endorser-tx body: value-identical to the generic decode below,
        which stays for the rows the scanner rejected."""
        if not env.payload:
            work.flag = V.NIL_ENVELOPE
            return
        if spine is not None:
            payload, ch, sh = spine.payload, spine.ch, spine.sh
        else:
            try:
                payload = protoutil.unmarshal_envelope_payload(env)
                ch = m.ChannelHeader.decode(payload.header.channel_header)
                sh = m.SignatureHeader.decode(
                    payload.header.signature_header)
            except Exception:
                work.flag = V.BAD_PAYLOAD
                return
        if not ch.channel_id or ch.channel_id != self.channel_id:
            work.flag = V.BAD_CHANNEL_HEADER
            return
        work.txid = ch.tx_id

        # creator signature (reference: msgvalidation.go:26)
        if not sh.creator or not env.signature:
            work.flag = V.BAD_CREATOR_SIGNATURE
            return
        try:
            creator = self._msp_mgr.deserialize_identity(sh.creator)
            self._msp_mgr.validate(creator)
        except Exception:
            work.flag = V.BAD_CREATOR_SIGNATURE
            return
        item = creator.verify_item(env.payload, env.signature)
        if item is not None:
            work.creator_slot = (collector.add(item), False)
        else:
            work.creator_slot = (
                None, creator.verify(env.payload, env.signature))

        if ch.type == m.HeaderType.CONFIG:
            work.is_config = True
            work.env = env                # finish re-validates+applies
            return                        # config txs skip endorsement
        if ch.type != m.HeaderType.ENDORSER_TRANSACTION:
            work.flag = V.UNKNOWN_TX_TYPE
            return

        # tx id binding (reference: utils.CheckTxID in msgvalidation)
        if ch.tx_id != protoutil.compute_tx_id(sh.nonce, sh.creator):
            work.flag = V.BAD_PROPOSAL_TXID
            return
        # the committed-store duplicate-txid check runs in pass 3: only
        # at finish time is the committed store guaranteed current

        # endorsement policy per action (reference: VSCC v20
        # validation_logic.go:185 + validator_keylevel.go:245-258:
        # data = proposal-response-payload ‖ endorser-identity)
        try:
            if body is not None:
                # the batch decoder's body: one action (the scanner
                # rejects multi-action txs into the generic decode)
                if body.no_action:
                    work.flag = V.NIL_TXACTION
                    return
                if not body.endorsements:
                    work.flag = V.ENDORSEMENT_POLICY_FAILURE
                    return
                self._stage_action(
                    body.ns, body.prp, body.endorsements,
                    lambda: body.groups, work, collector, inblock_vp,
                    session, body.lifecycle_write_keys)
                return
            tx = protoutil.extract_endorser_tx(payload)
            if not tx.actions:
                work.flag = V.NIL_TXACTION
                return
            for action in tx.actions:
                cca, prp, endorsements = \
                    protoutil.tx_rwset_and_endorsements(action)
                if not endorsements:
                    work.flag = V.ENDORSEMENT_POLICY_FAILURE
                    return
                ns = (cca.chaincode_id.name
                      if cca.chaincode_id is not None else "")
                if not self._stage_action(
                        ns, prp, [(e.endorser, e.signature)
                                  for e in endorsements],
                        functools.partial(_written_groups, cca.results),
                        work, collector, inblock_vp, session):
                    return
        except Exception:
            work.flag = V.INVALID_ENDORSER_TRANSACTION
            return

    def _stage_action(self, ns: str, prp: bytes, endorsements, written,
                      work: _TxWork, collector: BatchCollector, inblock_vp,
                      session, write_keys=None) -> bool:
        """Stage one action's chaincode-wide policy, then its key-level
        policies over `written()`, its written view per namespace
        occurrence (called after the chaincode-wide policy is staged: the
        generic decode of a malformed inner rwset raises there, as in the
        reference's order).  `write_keys(ns)`, the columnar body's write
        keys, spares `_resolve_vinfo` that decode.  False (work.flag
        set) when the namespace's definition names a plugin this peer
        does not have: fail closed."""
        plugin_name, policy_bytes = self._resolve_vinfo(ns, written,
                                                        write_keys)
        evaluator = self._plugins.resolve(plugin_name, self._policy_eval)
        if evaluator is None:
            work.flag = V.INVALID_OTHER_REASON
            return False
        sds = [SignedData(data=prp + endorser, identity=endorser,
                          signature=signature)
               for endorser, signature in endorsements]
        # the session rides only through evaluators that opt in; plugins
        # keep their 3-arg prepare contract
        if session is not None and getattr(
                evaluator, "supports_tensor_session", False):
            cc_pending = evaluator.prepare(policy_bytes, sds, collector,
                                           session)
        else:
            cc_pending = evaluator.prepare(policy_bytes, sds, collector)
        key_evals = self._stage_key_policies(written(), sds, collector,
                                             inblock_vp, work, session)
        work.actions.append(_ActionEval(cc_pending, key_evals))
        return True

    def _resolve_vinfo(self, ns: str, written, write_keys=None):
        """The validation info of one action (reference:
        txvalidator.py:427 `_resolve_vinfo`).  A `_lifecycle` action is
        resolved by its write keys where the provider can (an org-local
        approval validates against that org's Endorsement policy:
        peer/lifecycle.py); a rwset that does not decode falls back to
        the namespace's info, and validation surfaces the decode
        error."""
        write_aware = getattr(self._vinfo, "validation_info_for_writes",
                              None)
        if write_aware is not None and ns == LIFECYCLE_NS:
            try:
                if write_keys is not None:
                    keys = write_keys(ns)
                else:
                    keys = [k for g_ns, wkeys, _metas in written()
                            if g_ns == ns for k in wkeys]
            except Exception:
                keys = None
            if keys is not None:
                return write_aware(ns, keys)
        return self._vinfo.validation_info(ns)

    def _stage_key_policies(self, groups, sds, collector, inblock_vp,
                            work, session=None):
        """Stage every candidate key-level endorsement policy of this
        action's written keys: the committed VALIDATION_PARAMETER plus
        any same-block overrides whose applicability pass 3 resolves in
        order.  `groups` is the action's written view per namespace
        occurrence (batchdecode.TxBody.groups, or `_written_groups`')."""
        key_evals = []
        for ns, wkeys, metas in groups:
            if wkeys or metas:
                work.written_ns.add(ns)
            written = dict.fromkeys(
                list(wkeys) + [mkey for mkey, _entries in metas])
            for key in written:
                committed_pending = None
                if self._state_metadata is not None:
                    vp = self._state_metadata(ns, key)
                    if vp:
                        committed_pending = self._policy_eval.prepare(
                            vp, sds, collector, session)
                cands = inblock_vp.get((ns, key), ())
                inblock = [(idx, self._policy_eval.prepare(
                    vp, sds, collector, session))
                           for idx, vp in cands]
                # EVERY written key gets an eval entry: keys without an
                # effective VP resolve to None in pass 3 and force the
                # cc-wide policy (fail closed)
                key_evals.append(
                    _KeyEval(ns, key, committed_pending, inblock))
            # this tx's own VALIDATION_PARAMETER writes, for later txs
            # in the block (applied only if this tx is VALID)
            for mkey, entries in metas:
                for name, value in entries:
                    if name == VALIDATION_PARAMETER:
                        work.vp_writes.append((ns, mkey, value))
        return key_evals

    # -- the three passes -------------------------------------------------
    def stage(self, block: m.Block) -> StagedBlock:
        """Passes 1+2: host unpack/staging, then DISPATCH the device
        batch without awaiting it."""
        works: List[_TxWork] = []
        collector = BatchCollector()
        session = None
        if self._tensor_policy:
            session = tensorpolicy.TensorSession(self._msp_mgr,
                                                 self._config_seq)
        # (ns, key) -> [(tx_idx, ApplicationPolicy bytes)]: the
        # VALIDATION_PARAMETER writes of EARLIER txs in this block
        inblock_vp: Dict[tuple, list] = {}
        datas = block.data.data
        num = block.header.number
        with tracing.span("unpack", block=num, txs=len(datas)):
            t0 = time.perf_counter()
            # batch pre-passes (reference :549-591): the whole block's
            # envelope spine in one vectorized scan, then every spine-
            # accepted endorser tx's payload.data in one columnar body
            # decode; rows either scan could not prove clean come back
            # None and take the generic per-tx decode below (identical
            # outcomes)
            spines = batchdecode.decode_block_spine(datas)
            with tracing.span("body_decode", block=num, txs=len(datas)):
                body_datas: List[Optional[bytes]] = [
                    spine.payload.data if spine is not None
                    and spine.ch.type == m.HeaderType.ENDORSER_TRANSACTION
                    else None for spine in spines]
                rwsets = batchdecode.decode_block_rwsets(body_datas)
            if rwsets is not None:
                # the header facts ride along to the commit, value-
                # identical to the generic envelope_channel_header decode
                for idx, spine in enumerate(spines):
                    if spine is not None:
                        rwsets.txids[idx] = spine.ch.tx_id
                        rwsets.types[idx] = spine.ch.type
            decode_secs = time.perf_counter() - t0
            for idx, data in enumerate(datas):
                work = _TxWork()
                works.append(work)
                spine = spines[idx]
                if spine is not None:
                    env = spine.env
                else:
                    try:
                        env = m.Envelope.decode(data)
                    except Exception:
                        work.flag = V.BAD_PAYLOAD
                        continue
                body = rwsets.bodies[idx] if rwsets is not None else None
                self._stage_tx(env, work, collector, inblock_vp, session,
                               spine, body)
                for ns, key, vp in work.vp_writes:
                    inblock_vp.setdefault((ns, key), []).append((idx, vp))
        if session is not None and len(session):
            # the MSP principal matrix lands here, memoized per pair
            with tracing.span("policy_gather", block=num,
                              instances=len(session)):
                session.finalize()
        # pass 2: dispatch the device batch; with a tensor session the
        # verifier's fused seam may hand back a device-resident mask.
        # The span times the enqueue; the wait is verdict_await's
        with tracing.span("device_dispatch", block=num,
                          items=len(collector.items)):
            async_fn = None
            if session is not None:
                async_fn = getattr(self._verifier,
                                   "verify_many_fused_async", None)
            if async_fn is None:
                async_fn = getattr(self._verifier, "verify_many_async",
                                   None)
            if async_fn is not None:
                mask_fn = async_fn(collector.items)
            else:
                items = collector.items
                mask_fn = lambda: self._verifier.verify_many(items)  # noqa: E731
        return StagedBlock(block, self, works, mask_fn, session, rwsets,
                           sum(spine is None for spine in spines),
                           decode_secs)

    def finish(self, staged: StagedBlock) -> List[int]:
        """Pass 3: await the verdicts, then resolve flags in block
        order — duplicate marking and key-level overrides so later txs
        see exactly the effects of earlier VALID ones."""
        block, works = staged.block, staged.works
        mask = staged.resolve_mask()
        session = staged.session
        if session is not None and len(session):
            # one evaluator pass gives every policy verdict of the block
            with tracing.span("policy_device", block=block.header.number,
                              instances=len(session)):
                session.verdicts()
        flags: List[int] = []
        seen_txids = set()
        applied_vp: Dict[tuple, int] = {}   # (ns, key) -> writer tx_idx
        with tracing.span("policy_finish", block=block.header.number):
            for idx, work in enumerate(works):
                flag = self._finish_tx(work, mask, applied_vp)
                if flag == V.VALID and work.txid:
                    if work.txid in seen_txids or \
                            self._tx_id_exists(work.txid):
                        flag = V.DUPLICATE_TXID
                    else:
                        seen_txids.add(work.txid)
                if flag == V.VALID:
                    for ns, key, _vp in work.vp_writes:
                        applied_vp[(ns, key)] = idx
                flags.append(flag)
            protoutil.set_block_txflags(block, bytes(flags))
        return flags

    def validate(self, block: m.Block) -> List[int]:
        """Validate every tx of `block` with one device dispatch; the
        txflags go into the block metadata and are returned."""
        return self.finish(self.stage(block))

    def _finish_tx(self, work: _TxWork, mask, applied_vp) -> int:
        if work.flag != V.NOT_VALIDATED:
            return work.flag
        bidx, host_ok = work.creator_slot
        creator_ok = bool(mask[bidx]) if bidx is not None else host_ok
        if not creator_ok:
            return V.BAD_CREATOR_SIGNATURE
        if work.is_config:
            # (reference: validator.go:400-421 — re-validated against
            # the current bundle and applied; fail closed otherwise)
            if self._config_apply is None:
                return V.INVALID_CONFIG_TRANSACTION
            try:
                self._config_apply(work.env)
            except Exception:
                return V.INVALID_CONFIG_TRANSACTION
            return V.VALID
        for action in work.actions:
            uncovered = not action.key_evals
            for ke in action.key_evals:
                writer = applied_vp.get((ke.ns, ke.key))
                pending = None
                if writer is not None:
                    for tx_idx, cand in ke.inblock:
                        if tx_idx == writer:
                            pending = cand
                            break
                if pending is None:
                    pending = ke.committed
                if pending is None:
                    uncovered = True        # falls to the cc-wide policy
                    continue
                if not pending.finish(mask):
                    return V.ENDORSEMENT_POLICY_FAILURE
            if uncovered and not action.cc_pending.finish(mask):
                return V.ENDORSEMENT_POLICY_FAILURE
        return V.VALID


class Committer:
    """Validate + MVCC + commit, the peer's StoreBlock composition
    (reference: gossip/state/state.go:817 commitBlock -> coordinator
    StoreBlock -> validator -> kvledger CommitLegacy).  Strictly serial.

    `last_timings` holds, for the block committed last, the host-clock
    seconds of each stage: "stage" (pass 1 and the enqueue of pass 2;
    "decode" is its batch pre-passes), "verify" (waiting for the verify
    mask, and on the tensor path the policy evaluator queued behind it),
    "policy" (pass 3) and "commit" (MVCC and the ledger write);
    "policy_device_ms", the evaluator's device time when it ran on a
    CUDA mask, else None; and the rows the spine and body scans left to
    the generic decode, "spine_fallbacks" and "body_fallbacks" (None
    when the block was too small to scan)."""

    def __init__(self, validator: TxValidator, ledger):
        self.validator = validator
        self.ledger = ledger
        self.last_timings: Dict[str, Optional[float]] = {}

    def store_block(self, block: m.Block) -> List[int]:
        # the synchronous path records the same per-block timeline the
        # commit pipe does (reference :739-747)
        tl = tracing.start_timeline("sync", block.header.number)
        try:
            with tracing.timeline_scope(tl):
                t0 = time.perf_counter()
                staged = self.validator.stage(block)
                t1 = time.perf_counter()
                staged.resolve_mask()
                t2 = time.perf_counter()
                flags = self.validator.finish(staged)
                t3 = time.perf_counter()
                flags = self.ledger.commit_block(block, flags,
                                                 staged.rwsets)
                t4 = time.perf_counter()
        finally:
            tracing.finish_timeline(tl)
        session = staged.session
        rwsets = staged.rwsets
        self.last_timings = {
            "stage": t1 - t0, "decode": staged.decode_secs,
            "verify": t2 - t1, "policy": t3 - t2, "commit": t4 - t3,
            "policy_device_ms": (session.device_ms() if session is not None
                                 else None),
            "spine_fallbacks": staged.spine_fallbacks,
            "body_fallbacks": (rwsets.fallbacks if rwsets is not None
                               else None)}
        return flags
