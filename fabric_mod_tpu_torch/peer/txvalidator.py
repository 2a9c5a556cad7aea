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

Staging takes the reference's generic per-tx decode (`_stage_tx`,
`_stage_key_policies`), the path its columnar batch decoder falls back
to with identical outcomes.  MVCC and the commit follow in the ledger
(ledger/kvledger.py); `Committer` composes the three.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from fabric_mod_tpu_torch.ledger.rwsetutil import parse_tx_rwset
from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS
from fabric_mod_tpu_torch.peer.plugins import PluginRegistry
from fabric_mod_tpu_torch.policy import BatchCollector
from fabric_mod_tpu_torch.policy import tensorpolicy
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


class StagedBlock:
    """A block after passes 1+2: host staging done, device batch
    dispatched, verdicts pending (resolved by TxValidator.finish).
    `session` (tensor_policy only) is the block's tensor-policy
    session: resolve_mask hands it the verify mask before the host
    sync, so a device mask flows straight into the evaluator."""

    __slots__ = ("block", "validator", "works", "mask_fn", "_mask",
                 "session")

    def __init__(self, block, validator, works, mask_fn, session=None):
        self.block = block
        self.validator = validator
        self.works = works
        self.mask_fn = mask_fn
        self._mask = None
        self.session = session

    def resolve_mask(self) -> np.ndarray:
        """Await the device verdicts (idempotent)."""
        if self._mask is None:
            raw = self.mask_fn()
            if self.session is not None:
                # bind (and, on a device mask, enqueue) the whole-block
                # policy evaluator before the host sync
                self.session.attach_mask(raw)
            self._mask = _host_mask(raw)
            # the fused verify seam defers its verdict-cache write-back
            # to the consumer's sync point — this is it
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
                  session=None) -> None:
        """Syntactic validation + creator/endorsement staging for one
        tx.  Sets work.flag on terminal failure, else leaves it pending
        the device verdicts (reference: msgvalidation.go:248)."""
        if not env.payload:
            work.flag = V.NIL_ENVELOPE
            return
        try:
            payload = protoutil.unmarshal_envelope_payload(env)
            ch = m.ChannelHeader.decode(payload.header.channel_header)
            sh = m.SignatureHeader.decode(payload.header.signature_header)
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
            tx = protoutil.extract_endorser_tx(payload)
            if not tx.actions:
                work.flag = V.NIL_TXACTION
                return
            for action in tx.actions:
                cca, prp_bytes, endorsements = \
                    protoutil.tx_rwset_and_endorsements(action)
                if not endorsements:
                    work.flag = V.ENDORSEMENT_POLICY_FAILURE
                    return
                ns = (cca.chaincode_id.name
                      if cca.chaincode_id is not None else "")
                # one rwset decode per action, shared by key-level
                # policy staging
                try:
                    rwset = m.TxReadWriteSet.decode(cca.results)
                except Exception:
                    rwset = None
                plugin_name, policy_bytes = self._vinfo.validation_info(ns)
                evaluator = self._plugins.resolve(plugin_name,
                                                  self._policy_eval)
                if evaluator is None:
                    # the definition names a plugin this peer does not
                    # have: fail closed
                    work.flag = V.INVALID_OTHER_REASON
                    return
                sds = [SignedData(data=prp_bytes + e.endorser,
                                  identity=e.endorser,
                                  signature=e.signature)
                       for e in endorsements]
                # the session rides only through evaluators that opt
                # in; plugins keep their 3-arg prepare contract
                if session is not None and getattr(
                        evaluator, "supports_tensor_session", False):
                    cc_pending = evaluator.prepare(
                        policy_bytes, sds, collector, session)
                else:
                    cc_pending = evaluator.prepare(
                        policy_bytes, sds, collector)
                key_evals = self._stage_key_policies(
                    rwset, sds, collector, inblock_vp, work, session)
                work.actions.append(_ActionEval(cc_pending, key_evals))
        except Exception:
            work.flag = V.INVALID_ENDORSER_TRANSACTION
            return

    def _stage_key_policies(self, rwset, sds, collector, inblock_vp,
                            work, session=None):
        """Stage every candidate key-level endorsement policy of this
        action's written keys: the committed VALIDATION_PARAMETER plus
        any same-block overrides whose applicability pass 3 resolves in
        order.  `rwset` None (malformed) stages no key evals."""
        key_evals = []
        if rwset is None:
            return key_evals
        for ns, kv in parse_tx_rwset(rwset):
            if kv.writes or kv.metadata_writes:
                work.written_ns.add(ns)
            written = dict.fromkeys(
                [w.key for w in kv.writes]
                + [mw.key for mw in kv.metadata_writes])
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
            for mw in kv.metadata_writes:
                for e in mw.entries:
                    if e.name == VALIDATION_PARAMETER:
                        work.vp_writes.append((ns, mw.key, e.value))
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
        for idx, data in enumerate(block.data.data):
            work = _TxWork()
            works.append(work)
            try:
                env = m.Envelope.decode(data)
            except Exception:
                work.flag = V.BAD_PAYLOAD
                continue
            self._stage_tx(env, work, collector, inblock_vp, session)
            for ns, key, vp in work.vp_writes:
                inblock_vp.setdefault((ns, key), []).append((idx, vp))
        if session is not None and len(session):
            # the MSP principal matrix lands here, memoized per pair
            session.finalize()
        # pass 2: dispatch the device batch; with a tensor session the
        # verifier's fused seam may hand back a device-resident mask
        async_fn = None
        if session is not None:
            async_fn = getattr(self._verifier, "verify_many_fused_async",
                               None)
        if async_fn is None:
            async_fn = getattr(self._verifier, "verify_many_async", None)
        if async_fn is not None:
            mask_fn = async_fn(collector.items)
        else:
            items = collector.items
            mask_fn = lambda: self._verifier.verify_many(items)  # noqa: E731
        return StagedBlock(block, self, works, mask_fn, session)

    def finish(self, staged: StagedBlock) -> List[int]:
        """Pass 3: await the verdicts, then resolve flags in block
        order — duplicate marking and key-level overrides so later txs
        see exactly the effects of earlier VALID ones."""
        block, works = staged.block, staged.works
        mask = staged.resolve_mask()
        session = staged.session
        if session is not None and len(session):
            session.verdicts()
        flags: List[int] = []
        seen_txids = set()
        applied_vp: Dict[tuple, int] = {}   # (ns, key) -> writer tx_idx
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
    seconds of each stage: "stage" (pass 1 and the enqueue of pass 2),
    "verify" (waiting for the verify mask, and on the tensor path the
    policy evaluator queued behind it), "policy" (pass 3) and "commit"
    (MVCC and the ledger write); and "policy_device_ms", the
    evaluator's device time when it ran on a CUDA mask, else None."""

    def __init__(self, validator: TxValidator, ledger):
        self.validator = validator
        self.ledger = ledger
        self.last_timings: Dict[str, Optional[float]] = {}

    def store_block(self, block: m.Block) -> List[int]:
        t0 = time.perf_counter()
        staged = self.validator.stage(block)
        t1 = time.perf_counter()
        staged.resolve_mask()
        t2 = time.perf_counter()
        flags = self.validator.finish(staged)
        t3 = time.perf_counter()
        flags = self.ledger.commit_block(block, flags)
        t4 = time.perf_counter()
        session = staged.session
        self.last_timings = {
            "stage": t1 - t0, "verify": t2 - t1, "policy": t3 - t2,
            "commit": t4 - t3,
            "policy_device_ms": (session.device_ms() if session is not None
                                 else None)}
        return flags
