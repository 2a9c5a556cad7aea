"""Per-channel peer wiring: bundle + validator + committer + MCS.

The port's copy of fabric_mod_tpu/peer/channel.py `Channel` (:42;
reference: core/peer/peer.go:248 `createChannel`, which assembles the
validator, committer and config callbacks of one channel, and the
bundle swap of common/channelconfig/bundlesource.go:103).

The Channel owns the mutable piece, the current Bundle, and rebuilds
the per-bundle objects (policy evaluator, validator) atomically when a
CONFIG tx commits; everything downstream reads through `bundle()` and
`validator()`, so a block validates under exactly one config snapshot.
Left out: private data and the shard router.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from fabric_mod_tpu_torch.channelconfig import (
    Bundle, ConfigTxError, extract_config_update, propose_config_update)
from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
from fabric_mod_tpu_torch.peer.lifecycle import LifecycleValidationInfo
from fabric_mod_tpu_torch.peer.mcs import MessageCryptoService
from fabric_mod_tpu_torch.peer.txvalidator import (
    VALIDATION_PARAMETER, TxValidator, ValidationInfoProvider)
from fabric_mod_tpu_torch.policy import ApplicationPolicyEvaluator
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

# the endorsement policy of a namespace without a chaincode definition
# (reference: lifecycle's default /Channel/Application/Endorsement)
DEFAULT_ENDORSEMENT_REF = "/Channel/Application/Endorsement"


class Channel:
    """One channel on one peer (reference: core/peer/peer.go Channel).

    `tensor_policy` evaluates each block's endorsement policies in one
    tensor pass on the verify mask's device (policy/tensorpolicy.py).
    `pipeline_depth` > 0 routes `store_block` through the channel's
    shared PipelinedCommitter of that depth; 0 commits synchronously."""

    def __init__(self, channel_id: str, ledger, verifier, bundle: Bundle,
                 csp, vinfo: Optional[ValidationInfoProvider] = None,
                 plugin_registry=None, tensor_policy: bool = False,
                 pipeline_depth: int = 0):
        self.channel_id = channel_id
        self.ledger = ledger
        self.verifier = verifier
        self._csp = csp
        self._plugin_registry = plugin_registry
        self._tensor_policy = tensor_policy
        self._pipeline_depth = pipeline_depth
        self._lock = threading.Lock()
        self._commit_pipe: Optional[PipelinedCommitter] = None
        # serializes pipe rebuilds; never held by the pipe's threads,
        # so the drain-join inside cannot deadlock
        self._pipe_rebuild_lock = threading.Lock()
        if vinfo is None:
            # committed chaincode definitions resolve each namespace's
            # endorsement policy (peer/lifecycle.py)
            def state_get(ns: str, key: str):
                got = self.ledger.state.get_state(ns, key)
                return got[0] if got else None
            vinfo = LifecycleValidationInfo(
                state_get,
                m.ApplicationPolicy(
                    channel_config_policy_reference=DEFAULT_ENDORSEMENT_REF
                ).encode())
        self._vinfo = vinfo
        self.mcs = MessageCryptoService(self.bundle, verifier)
        self._install_bundle(bundle)

    # -- bundle lifecycle -------------------------------------------------
    def _install_bundle(self, bundle: Bundle) -> None:
        # the bundle's MSP manager carries its own per-bundle caches
        # (channelconfig/bundle.py), so a config update starts cold
        mgr = bundle.msp_manager
        policy_eval = ApplicationPolicyEvaluator(
            mgr, bundle.policy_manager, sequence=bundle.sequence)

        def state_vp(ns: str, key: str):
            meta = self.ledger.state.get_metadata(ns, key)
            return meta.get(VALIDATION_PARAMETER) if meta else None

        validator = TxValidator(
            self.channel_id, mgr, policy_eval, self.verifier, self._vinfo,
            tx_id_exists=self.ledger.tx_id_exists,
            config_apply=self._validate_and_apply_config,
            state_metadata=state_vp,
            plugin_registry=self._plugin_registry,
            config_sequence=bundle.sequence,
            tensor_policy=self._tensor_policy)
        with self._lock:
            self._bundle = bundle
            self._validator = validator

    def bundle(self) -> Bundle:
        with self._lock:
            return self._bundle

    def validator(self) -> TxValidator:
        with self._lock:
            return self._validator

    # -- config tx path ---------------------------------------------------
    def _validate_and_apply_config(self, env: m.Envelope) -> None:
        """Re-validate an ordered CONFIG envelope against the current
        bundle and adopt it (reference: validator.go:400-421).  Called
        from inside block validation; raising marks the tx
        INVALID_CONFIG_TRANSACTION."""
        payload = protoutil.unmarshal_envelope_payload(env)
        cenv = m.ConfigEnvelope.decode(payload.data)
        if cenv.config is None:
            raise ConfigTxError("config envelope carries no config")
        if cenv.last_update is None:
            raise ConfigTxError("config envelope carries no last_update")
        cue = extract_config_update(cenv.last_update)
        verify_many = (self.verifier.verify_many
                       if self.verifier is not None else None)
        computed = propose_config_update(self.bundle(), cue, verify_many)
        if computed.encode() != cenv.config.encode():
            raise ConfigTxError(
                "ordered config does not match the one computed from "
                "last_update under the current bundle")
        self._install_bundle(Bundle(self.channel_id, computed, self._csp))

    def init_from_genesis(self, genesis_block: m.Block) -> List[int]:
        """Commit block 0 (the trust anchor, validated out of band:
        reference: peer channel join)."""
        flags = [m.TxValidationCode.VALID] * len(genesis_block.data.data)
        protoutil.set_block_txflags(genesis_block, bytes(flags))
        return self.ledger.commit_block(genesis_block, flags)

    # -- commit path ------------------------------------------------------
    def store_block(self, block: m.Block) -> List[int]:
        """validate -> MVCC -> commit (the reference's coordinator
        StoreBlock, gossip/state/state.go:817).  With a pipeline depth
        the call is still synchronous — it returns THIS block's final
        flags — but overlapping callers pipeline."""
        pipe = self.commit_pipeline()
        if pipe is None:
            flags = self.validator().validate(block)
            return self.ledger.commit_block(block, flags)
        try:
            return pipe.store_block(block)
        except Exception:
            # the failure may be inherited from a pipe another caller's
            # block poisoned: one retry through a fresh pipe separates
            # that from this block's own error (which fails again)
            retry = self.commit_pipeline()
            if retry is pipe:
                raise
            return retry.store_block(block)

    def commit_pipeline(self) -> Optional[PipelinedCommitter]:
        """The channel's shared PipelinedCommitter (None at depth 0).

        A failed pipe is sticky only until its error has been surfaced:
        the next call here discards it and builds a fresh one from the
        committed height, so one bad block never bricks the channel.
        The old engine is fully drained first: two engines never run
        against the ledger at once."""
        if self._pipeline_depth <= 0:
            return None

        def healthy():
            with self._lock:
                pipe = self._commit_pipe
            return pipe if (pipe is not None and pipe.error is None
                            and not pipe.closed) else None
        pipe = healthy()
        if pipe is not None:
            return pipe
        with self._pipe_rebuild_lock:
            pipe = healthy()
            if pipe is not None:
                return pipe                # another caller rebuilt
            with self._lock:
                old, self._commit_pipe = self._commit_pipe, None
            if old is not None:
                old.close()
            pipe = PipelinedCommitter(self, depth=self._pipeline_depth)
            with self._lock:
                self._commit_pipe = pipe
            return pipe

    # the pipelined split: stage (host unpack + async device dispatch)
    # may run ahead of the previous block's commit; commit_staged
    # resolves the verdicts and commits
    def stage_block(self, block: m.Block):
        return self.validator().stage(block)

    def commit_staged(self, staged) -> List[int]:
        # finish on the validator that staged: its pending evaluations
        # hold that validator's batch slots
        flags = staged.validator.finish(staged)
        return self.ledger.commit_block(staged.block, flags)

    def close(self) -> None:
        """Drain and join the shared commit pipe, if one was built."""
        with self._lock:
            pipe, self._commit_pipe = self._commit_pipe, None
        if pipe is not None:
            pipe.close()
