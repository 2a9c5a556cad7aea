"""Multichannel registrar: per-channel chain resources.

The port's copy of fabric_mod_tpu/orderer/registrar.py `Registrar` (:95)
and `ChainSupport` (:35) (reference: orderer/common/multichannel/
registrar.go — Initialize :155, BroadcastChannelSupport :259,
CreateChain :340 — and chainsupport.go:288).  Every channel runs the
solo consenter; channel participation (join, follower, remove) is not
ported.

A ChainSupport owns one channel's bundle (swapped atomically on config
commit), block cutter, block writer, ingress processor and consenter.
The registrar bootstraps each channel found on disk from its tip config
block on open: the ledger is the config store.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.ledger.blkstorage import BlockStore
from fabric_mod_tpu_torch.orderer.blockcutter import BlockCutter
from fabric_mod_tpu_torch.orderer.blockwriter import (BlockWriter,
                                                      last_config_index)
from fabric_mod_tpu_torch.orderer.consensus import SoloChain
from fabric_mod_tpu_torch.orderer.msgprocessor import StandardChannelProcessor
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


class RegistrarError(Exception):
    pass


class ChainSupport:
    """(reference: multichannel/chainsupport.go ChainSupport)"""

    def __init__(self, channel_id: str, store: BlockStore, bundle: Bundle,
                 signer, csp):
        self.channel_id = channel_id
        self.store = store
        self._bundle = bundle
        self._bundle_lock = threading.Lock()
        self._csp = csp
        self.cutter = BlockCutter(bundle.batch_config())
        self.writer = BlockWriter(store, signer, channel_id)
        self.processor = StandardChannelProcessor(
            self.bundle, signer=signer)
        self.chain = SoloChain(self)

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
    """(reference: multichannel/registrar.go)"""

    def __init__(self, root_dir: str, signer, csp):
        self._root = root_dir
        self._signer = signer
        self._csp = csp
        self._chains: Dict[str, ChainSupport] = {}
        self._lock = threading.Lock()
        os.makedirs(root_dir, exist_ok=True)
        # recover existing channels from disk (reference: Initialize)
        for name in sorted(os.listdir(root_dir)):
            path = os.path.join(root_dir, name)
            if os.path.isdir(path):
                self._open_channel(name, path)

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
        support = ChainSupport(cid, store, Bundle(cid, config, self._csp),
                               self._signer, self._csp)
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
            support = ChainSupport(cid, store, Bundle(cid, config, self._csp),
                                   self._signer, self._csp)
            self._chains[cid] = support
        support.start()
        return support

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
