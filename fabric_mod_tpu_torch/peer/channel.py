"""Per-channel peer wiring: bundle + validator + committer + MCS.

The port's copy of fabric_mod_tpu/peer/channel.py `Channel` (:42;
reference: core/peer/peer.go:248 `createChannel`, which assembles the
validator, committer and config callbacks of one channel, and the
bundle swap of common/channelconfig/bundlesource.go:103).

The Channel owns the mutable piece, the current Bundle, and rebuilds
the per-bundle objects (policy evaluator, validator) atomically when a
CONFIG tx commits; everything downstream reads through `bundle()` and
`validator()`, so a block validates under exactly one config snapshot.
`use_shard_router` binds the channel to a sharding.ChannelShardRouter,
whose slice-pinned pipe then commits its blocks.

Private data (:77-130): the channel owns a TransientStore and a
PvtDataStore — under `<ledger dir>/transient` and `/pvtdata` when the
ledger is durable, in memory otherwise — and attaches them to its
ledger with the BTL of each collection.  A collection's config (its
member-orgs policy and block-to-live) is read from the committed
chaincode definition in `_lifecycle`.
"""
from __future__ import annotations

import os
from typing import List, Optional

from fabric_mod_tpu_torch.channelconfig import (
    Bundle, ConfigTxError, extract_config_update, propose_config_update)
from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.peer.commitpipe import PipelinedCommitter
from fabric_mod_tpu_torch.ledger.pvtdata import PvtDataStore, TransientStore
from fabric_mod_tpu_torch.peer.lifecycle import (
    LIFECYCLE_NS, LifecycleValidationInfo, definition_key)
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
    shared PipelinedCommitter of that depth; 0 commits synchronously
    (unless a shard router is bound: `use_shard_router`)."""

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
        self._lock = RegisteredLock("peer.channel._lock")
        self._commit_pipe: Optional[PipelinedCommitter] = None
        self._shard_router = None
        # serializes pipe rebuilds; never held by the pipe's threads,
        # so the drain-join inside cannot deadlock
        self._pipe_rebuild_lock = RegisteredLock(
            "peer.channel._pipe_rebuild_lock")
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
        # private data: on a durable ledger both stores are durable too,
        # so committed plaintext and the missing-digest index survive a
        # restart
        pvt_root = ledger.dir if ledger.durable else None
        self.transient_store = TransientStore(
            dir_path=os.path.join(pvt_root, "transient") if pvt_root
            else None)
        self.pvtdata_store = PvtDataStore(
            dir_path=os.path.join(pvt_root, "pvtdata") if pvt_root
            else None)
        self.ledger.attach_pvt(self.transient_store, self.pvtdata_store,
                               self._collection_btl)
        self._install_bundle(bundle)

    def _static_collection_config(self, ns: str, collection: str):
        """The committed StaticCollectionConfig of (chaincode,
        collection), or None (reference: privdata's collection-config
        retrieval from the lifecycle definition)."""
        got = self.ledger.state.get_state(LIFECYCLE_NS, definition_key(ns))
        if got is None:
            return None
        try:
            d = m.ChaincodeDefinition.decode(got[0])
            pkg = m.CollectionConfigPackage.decode(d.collections)
        except ValueError:
            return None                    # malformed: no collection
        for cc in pkg.config:
            sc = cc.static_collection_config
            if sc is not None and sc.name == collection:
                return sc
        return None

    def collection_policy(self, ns: str, collection: str):
        """The member_orgs_policy (SignaturePolicyEnvelope) of a
        committed collection config, or None."""
        sc = self._static_collection_config(ns, collection)
        return sc.member_orgs_policy if sc is not None else None

    def _collection_btl(self, ns: str, collection: str) -> int:
        """The block-to-live of a committed collection config; 0 (never
        purged) without one."""
        sc = self._static_collection_config(ns, collection)
        return sc.block_to_live if sc is not None else 0

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
            return self.commit_staged(self.stage_block(block))
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

    def use_shard_router(self, router) -> None:
        """Bind this channel to a ChannelShardRouter (sharding/):
        commit_pipeline() then delegates to the router's slice-pinned
        engine, which carries the same rebuild-on-poison contract.  The
        router must already hold this channel (add_channel); binding is
        one-way for the channel's lifetime.  A pipe built before the
        binding is DRAINED first, and the router target binds only after
        that drain, so the router cannot build the slice engine while
        the old one still commits."""
        with self._pipe_rebuild_lock:
            with self._lock:
                old, self._commit_pipe = self._commit_pipe, None
            if old is not None:
                old.close()
            router.bind_target(self.channel_id, self)
            with self._lock:
                self._shard_router = router

    def commit_pipeline(self) -> Optional[PipelinedCommitter]:
        """The channel's shared PipelinedCommitter: the shard router's
        slice-pinned one when a router is bound, else its own (None at
        depth 0).

        A failed pipe is sticky only until its error has been surfaced:
        the next call here discards it and builds a fresh one from the
        committed height, so one bad block never bricks the channel.
        The old engine is fully drained first: two engines never run
        against the ledger at once."""
        with self._lock:
            router = self._shard_router
        if router is not None:
            return router.pipeline_for(self.channel_id)
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
            with self._lock:
                router = self._shard_router
            if router is not None:
                # a use_shard_router() bind landed while we waited on
                # the rebuild lock: delegate, never a second engine
                return router.pipeline_for(self.channel_id)
            pipe = healthy()
            if pipe is not None:
                return pipe                # another caller rebuilt
            with self._lock:
                old, self._commit_pipe = self._commit_pipe, None
            if old is not None:
                old.close()
            pipe = PipelinedCommitter(self, depth=self._pipeline_depth,
                                      consumer="channel")
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
        return self.ledger.commit_block(staged.block, flags, staged.rwsets)

    def close(self) -> None:
        """Drain and join the channel's own commit pipe, if one was built
        (a bound shard router's pipe is the router's to close)."""
        with self._lock:
            pipe, self._commit_pipe = self._commit_pipe, None
        if pipe is not None:
            pipe.close()
