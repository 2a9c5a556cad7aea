"""Multichannel registrar: per-channel chain resources.

The port's copy of fabric_mod_tpu/orderer/registrar.py `Registrar` (:95)
and `ChainSupport` (:35) (reference: orderer/common/multichannel/
registrar.go — Initialize :155, BroadcastChannelSupport :259,
CreateChain :340 — and chainsupport.go:288).  A channel's consenter is
chosen by its ConsensusType: `consenters` maps a type to a factory
(`support -> chain`), `chain_factory` overrides it for every channel,
and an unregistered type runs solo (reference :99-138, :157-165).

Channel participation (reference :191-289, orderer/participation.py):
`join_channel` joins from a genesis block or onboards from a later
config block, replicating the chain from `block_fetcher` and checking it
(hash chain, the join-block anchor, and each block's orderer signature
through the MCS with the registrar's `verifier`: on the card with a
GpuVerifier) before anything is written; a `.joining` marker keeps a
half-replicated channel down across a restart.  `as_follower` stores
and follows without ordering (a FollowerChain), and the `.follower`
marker keeps it a follower when the registrar reopens.
`remove_channel` halts a channel and deletes its storage.
`submit_queue_cap` is the admission setting (orderer/admission.py):
> 0 bounds each solo chain's submit queue with non-blocking puts;
chain factories read it from `ChainSupport.submit_queue_cap`.

A ChainSupport owns one channel's bundle (swapped atomically on config
commit), block cutter, block writer, ingress processor and consenter.
The registrar's `verify_many` (None: the host) is every channel
processor's Writers-check verifier (reference :39, :98).
The registrar bootstraps each channel found on disk from its tip config
block on open: the ledger is the config store, and a Raft channel's
chain reopens over its existing WAL.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Optional, Tuple

from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.ledger.blkstorage import BlockStore
from fabric_mod_tpu_torch.orderer.blockcutter import BlockCutter
from fabric_mod_tpu_torch.orderer.blockwriter import (BlockWriter,
                                                      last_config_index)
from fabric_mod_tpu_torch.orderer.consensus import SoloChain
from fabric_mod_tpu_torch.orderer.msgprocessor import StandardChannelProcessor
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


# a channel directory's markers: mid-onboarding, and a follower channel
JOINING = ".joining"
FOLLOWER_MARKER = ".follower"


class RegistrarError(Exception):
    pass


class ChainSupport:
    """(reference: multichannel/chainsupport.go ChainSupport)"""

    def __init__(self, channel_id: str, store: BlockStore, bundle: Bundle,
                 signer, csp, verify_many=None, chain_factory=None,
                 submit_queue_cap: int = 0):
        self.channel_id = channel_id
        self.store = store
        self.submit_queue_cap = submit_queue_cap
        self._bundle = bundle
        self._bundle_lock = RegisteredLock("orderer.registrar._bundle_lock")
        self._csp = csp
        self.cutter = BlockCutter(bundle.batch_config())
        self.writer = BlockWriter(store, signer, channel_id)
        self.processor = StandardChannelProcessor(
            self.bundle, signer=signer, verify_many=verify_many)
        # the consenter (reference :39-54): solo unless a factory is given
        self.chain = (chain_factory(self) if chain_factory is not None
                      else SoloChain(self, queue_cap=submit_queue_cap))

    def bundle(self) -> Bundle:
        with self._bundle_lock:
            return self._bundle

    def sequence(self) -> int:
        return self.bundle().sequence

    def batch_timeout_s(self) -> float:
        return self.bundle().orderer.batch_timeout_s

    # -- consenter callbacks ---------------------------------------------
    def process_config(self, config_env: m.Envelope,
                       block: m.Block) -> None:
        """Write a config block and swap the live bundle (reference:
        chainsupport WriteConfigBlock -> bundle update callback)."""
        _, new_config = config_from_block(block)
        new_bundle = Bundle(self.channel_id, new_config, self._csp)
        self.writer.write_block(block, is_config=True)
        with self._bundle_lock:
            self._bundle = new_bundle
        self.cutter.config = new_bundle.batch_config()

    def append_pulled(self, block: m.Block, is_config: bool) -> None:
        """Append a block pulled from another orderer as it was signed
        (a follower); a config block swaps the live bundle."""
        if is_config:
            _, new_config = config_from_block(block)
            new_bundle = Bundle(self.channel_id, new_config, self._csp)
            self.writer.append_signed(block, is_config=True)
            with self._bundle_lock:
                self._bundle = new_bundle
            self.cutter.config = new_bundle.batch_config()
        else:
            self.writer.append_signed(block)

    def reprocess_config(self, env: m.Envelope) -> Tuple:
        wrapped, seq = self.processor.process_config_update_msg(env)
        return wrapped, True, seq

    def revalidate_normal(self, env: m.Envelope) -> None:
        self.processor.process_normal_msg(env)

    def start(self) -> None:
        self.chain.start()

    def halt(self) -> None:
        self.chain.halt()


class Registrar:
    """(reference: multichannel/registrar.go)

    `block_fetcher(lo, hi) -> [Block]` is the replication source of
    follower channels and non-genesis joins (reference: the cluster
    block puller; hi 0 means the source's tip).  `verifier` is the batch
    verify seam the participation paths check pulled blocks with (a
    GpuVerifier: on the card; None: the host)."""

    def __init__(self, root_dir: str, signer, csp, verify_many=None,
                 chain_factory=None, consenters=None, block_fetcher=None,
                 verifier=None, submit_queue_cap: int = 0):
        self._root = root_dir
        self._signer = signer
        self._csp = csp
        self._verify_many = verify_many
        self._chain_factory = chain_factory
        self._consenters = dict(consenters or {})
        self.block_fetcher = block_fetcher
        self._verifier = verifier
        self._queue_cap = submit_queue_cap
        self._chains: Dict[str, ChainSupport] = {}
        # channel ids being joined or removed right now: reserved, so a
        # concurrent join or remove of the same id cannot interleave
        self._busy: set = set()
        self._lock = RegisteredLock("orderer.registrar._lock")
        os.makedirs(root_dir, exist_ok=True)
        # recover existing channels from disk (reference: Initialize); a
        # directory with a .joining marker died mid-onboarding: its
        # chain was never checked and must not come up
        for name in sorted(os.listdir(root_dir)):
            path = os.path.join(root_dir, name)
            if os.path.isdir(path) and not os.path.exists(
                    os.path.join(path, JOINING)):
                self._open_channel(name, path)

    def _resolve_factory(self, bundle: Bundle):
        """The consenter factory for a channel's ConsensusType
        (reference: registrar.go consenters[consensusType]); an explicit
        chain_factory wins, an unregistered type runs solo (None)."""
        if self._chain_factory is not None:
            return self._chain_factory
        return self._consenters.get(bundle.orderer.consensus_type)

    def _open_channel(self, channel_id: str, path: str) -> None:
        store = BlockStore(path)
        if store.height == 0:
            store.close()
            return
        # the latest config block, via the tip's last-config pointer
        tip = store.get_block_by_number(store.height - 1)
        cfg_block = store.get_block_by_number(last_config_index(tip) or 0)
        cid, config = config_from_block(cfg_block)
        if cid != channel_id:
            store.close()
            raise RegistrarError(
                f"directory {channel_id!r} holds channel {cid!r}")
        bundle = Bundle(cid, config, self._csp)
        factory = self._resolve_factory(bundle)
        if os.path.exists(os.path.join(path, FOLLOWER_MARKER)):
            # a follower stays a follower across restarts: a non-member
            # must never come back up ordering (reference :154-162)
            factory = self._follower_factory(self.block_fetcher)
        support = ChainSupport(cid, store, bundle, self._signer, self._csp,
                               self._verify_many, factory, self._queue_cap)
        self._chains[cid] = support
        support.start()

    def create_channel(self, genesis_block: m.Block) -> ChainSupport:
        """(reference: registrar.go:340 CreateChain, from a pre-built
        genesis block — the configtxgen output)"""
        cid, config = config_from_block(genesis_block)
        with self._lock:
            if cid in self._chains:
                raise RegistrarError(f"channel {cid!r} exists")
            store = BlockStore(os.path.join(self._root, cid))
            if store.height == 0:
                store.add_block(genesis_block)
            bundle = Bundle(cid, config, self._csp)
            support = ChainSupport(cid, store, bundle, self._signer,
                                   self._csp, self._verify_many,
                                   self._resolve_factory(bundle),
                                   self._queue_cap)
            self._chains[cid] = support
        support.start()
        return support

    def _follower_factory(self, fetch):
        from fabric_mod_tpu_torch.orderer.participation import FollowerChain

        def factory(support):
            return FollowerChain(support, fetch, verifier=self._verifier)
        return factory

    # -- channel participation (reference :191-289) ----------------------
    def join_channel(self, join_block: m.Block, block_fetcher=None,
                     as_follower: bool = False) -> ChainSupport:
        """Join from a genesis block, or onboard from a later config
        block by replicating and checking the chain first (anchored to
        the join block).  `as_follower` stores and follows without
        ordering.  Replication runs outside the registrar lock (a slow
        source must not stall the other channels); the id is reserved
        instead."""
        from fabric_mod_tpu_torch.orderer.participation import (
            ChainVerifier, replicate_chain)
        cid, _config = config_from_block(join_block)
        fetch = block_fetcher or self.block_fetcher
        with self._lock:
            if cid in self._chains or cid in self._busy:
                raise RegistrarError(f"channel {cid!r} exists or is "
                                     "being joined or removed")
            self._busy.add(cid)
        store = None
        try:
            path = os.path.join(self._root, cid)
            marker = os.path.join(path, JOINING)
            if os.path.exists(marker):
                # an earlier join died mid-replication: its partial
                # chain was never checked — wipe it and start over
                shutil.rmtree(path, ignore_errors=True)
            os.makedirs(path, exist_ok=True)
            store = BlockStore(path)
            if as_follower:
                # before the .joining marker goes: a crash between the
                # two must never restart a follower as an ordering member
                with open(os.path.join(path, FOLLOWER_MARKER), "w"):
                    pass
            if join_block.header.number == 0:
                if store.height == 0:
                    store.add_block(join_block)
            else:
                with open(marker, "w"):
                    pass
                bundle = None
                if store.height:
                    tip = store.get_block_by_number(store.height - 1)
                    _, cfg = config_from_block(store.get_block_by_number(
                        last_config_index(tip) or 0))
                    bundle = Bundle(cid, cfg, self._csp)
                checker = ChainVerifier(cid, self._csp, self._verifier,
                                        bundle)
                replicate_chain(store, join_block, fetch, checker.check)
                os.remove(marker)
            # the bundle of the latest config block now in the store
            tip = store.get_block_by_number(store.height - 1)
            cfg_block = store.get_block_by_number(last_config_index(tip)
                                                  or 0)
            _cid, config = config_from_block(cfg_block)
            bundle = Bundle(cid, config, self._csp)
            factory = (self._follower_factory(fetch) if as_follower
                       else self._resolve_factory(bundle))
            support = ChainSupport(cid, store, bundle, self._signer,
                                   self._csp, self._verify_many, factory,
                                   self._queue_cap)
            # started before it is published (the id still reserved): a
            # concurrent remove never halts a chain that never started
            support.start()
            with self._lock:
                self._chains[cid] = support
        except Exception:
            if store is not None:
                store.close()
            raise
        finally:
            with self._lock:
                self._busy.discard(cid)
        return support

    def remove_channel(self, channel_id: str) -> None:
        """Halt a channel and delete its chain and storage (reference
        :262); the id stays reserved until the files are gone."""
        with self._lock:
            support = self._chains.pop(channel_id, None)
            if support is None:
                raise RegistrarError(f"unknown channel {channel_id!r}")
            self._busy.add(channel_id)
        try:
            support.halt()
            support.store.close()
            shutil.rmtree(os.path.join(self._root, channel_id),
                          ignore_errors=True)
        finally:
            with self._lock:
                self._busy.discard(channel_id)

    def channel_ids(self):
        with self._lock:
            return sorted(self._chains)

    def get_chain(self, channel_id: str) -> Optional[ChainSupport]:
        with self._lock:
            return self._chains.get(channel_id)

    def broadcast_channel_support(self, env: m.Envelope
                                  ) -> Tuple[ChainSupport, bool]:
        """Route an incoming envelope: (support, is_config_update)
        (reference: registrar.go:259 BroadcastChannelSupport)."""
        ch = protoutil.envelope_channel_header(env)
        support = self.get_chain(ch.channel_id)
        if support is None:
            raise RegistrarError(f"unknown channel {ch.channel_id!r}")
        return support, ch.type == m.HeaderType.CONFIG_UPDATE

    def close(self) -> None:
        with self._lock:
            for support in self._chains.values():
                support.halt()
                support.store.close()
            self._chains.clear()
