"""Block creation, signing and append for the ordering service.

The port's copy of fabric_mod_tpu/orderer/blockwriter.py (`BlockWriter`
:38, `block_signed_data` :26; reference: orderer/common/multichannel/
blockwriter.go — CreateNextBlock :67, WriteBlock :168,
addBlockSignature :191 — and the LAST_CONFIG tracking).

The orderer's signature lives in block metadata[SIGNATURES] as a
Metadata message whose value carries the last-config index; the signed
bytes are value ‖ signature_header ‖ encoded block header, so tampering
with the data hash chain or the metadata breaks the signature.  The
signer is the orderer's SigningIdentity, whose signatures are the port's
RFC 6979 ECDSA (bccsp/sw.py).  Peers verify it against the channel's
/Channel/Orderer/BlockValidation policy before committing (peer/mcs.py).
"""
from __future__ import annotations

import threading
from typing import Sequence

from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


def block_signed_data(block: m.Block, md_value: bytes,
                      sig_header: bytes) -> bytes:
    """The exact bytes an orderer signs over a block (and a peer
    verifies): metadata value ‖ signature header ‖ block header."""
    return md_value + sig_header + block.header.encode()


last_config_index = protoutil.block_last_config_index


class BlockWriter:
    """Creates, signs and appends blocks for one channel.  Readers wait
    on `height_changed` for new blocks."""

    def __init__(self, store, signer, channel_id: str):
        self._store = store
        self._signer = signer
        self.channel_id = channel_id
        self._lock = RegisteredLock("orderer.blockwriter._lock")
        self.height_changed = threading.Condition()
        # the last-config pointer from the tip (reference: blockwriter
        # newBlockWriter reads lastConfigBlockNum)
        self._last_config = 0
        h = store.height
        if h > 0:
            lc = last_config_index(store.get_block_by_number(h - 1))
            if lc is not None:
                self._last_config = lc

    def create_next_block(self, envs: Sequence[m.Envelope]) -> m.Block:
        """(reference: blockwriter.go:67 CreateNextBlock)"""
        h = self._store.height
        prev = self._store.last_block_hash if h else b""
        return protoutil.new_block(h, prev, envs)

    def write_block(self, block: m.Block, is_config: bool = False) -> None:
        """Sign the metadata and append (reference: blockwriter.go:168
        WriteBlock + :191 addBlockSignature).  The consenter loop is the
        only writer; the lock is a guard."""
        with self._lock:
            if is_config:
                self._last_config = block.header.number
            md_value = m.LastConfig(index=self._last_config).encode()
            sigs = []
            if self._signer is not None:
                sig_header = protoutil.make_signature_header(
                    self._signer.serialize(), protoutil.new_nonce()).encode()
                signed = block_signed_data(block, md_value, sig_header)
                sigs.append(m.MetadataSignature(
                    signature_header=sig_header,
                    signature=self._signer.sign_message(signed)))
            meta = m.Metadata(value=md_value, signatures=sigs)
            md = block.metadata.metadata
            while len(md) <= m.BlockMetadataIndex.SIGNATURES:
                md.append(b"")
            md[m.BlockMetadataIndex.SIGNATURES] = meta.encode()
            self._store.add_block(block)
        with self.height_changed:
            self.height_changed.notify_all()

    def append_signed(self, block: m.Block, is_config: bool = False) -> None:
        """Append a block another orderer already signed, unchanged (a
        follower's pull); a config block moves the last-config
        pointer."""
        with self._lock:
            if is_config:
                self._last_config = block.header.number
            self._store.add_block(block)
        with self.height_changed:
            self.height_changed.notify_all()

    @property
    def last_config(self) -> int:
        return self._last_config

    @property
    def height(self) -> int:
        return self._store.height
