"""Message crypto service: block signature verification for the peer.

The port's copy of fabric_mod_tpu/peer/mcs.py `MessageCryptoService`
(:29; reference: internal/peer/gossip/mcs.go:124 `VerifyBlock` — the
data-hash recomputation and the orderer block-signature policy —
consumed by the deliver client before a block may enter the commit
queue, blocksprovider.go:227).

The signature check goes through the channel's
/Channel/Orderer/BlockValidation policy and the channel's batch
verifier: with a GpuVerifier that is one device call per block.
"""
from __future__ import annotations

from typing import Callable, Optional

from fabric_mod_tpu_torch.channelconfig.bundle import Bundle
from fabric_mod_tpu_torch.orderer.blockwriter import block_signed_data
from fabric_mod_tpu_torch.policy.manager import CHANNEL_ORDERER_BLOCK_VALIDATION
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.protos.protoutil import SignedData


class BlockVerificationError(Exception):
    pass


class MessageCryptoService:
    """`bundle_fn` returns the channel's CURRENT bundle; `verifier` is
    the batch verify seam (GpuVerifier, or a host verifier)."""

    def __init__(self, bundle_fn: Callable[[], Bundle], verifier=None):
        self._bundle = bundle_fn
        self._verifier = verifier

    def verify_block(self, channel_id: str, block: m.Block,
                     expected_prev_hash: Optional[bytes] = None) -> None:
        """Raises BlockVerificationError unless the block is
        well-formed, hash-consistent, and signed per the orderer
        block-validation policy (reference: mcs.go:124)."""
        if block.header is None or block.data is None:
            raise BlockVerificationError("block missing header/data")
        if expected_prev_hash is not None and \
                block.header.previous_hash != expected_prev_hash:
            raise BlockVerificationError(
                f"block {block.header.number}: previous-hash mismatch")
        if protoutil.block_data_hash(block.data) != block.header.data_hash:
            raise BlockVerificationError(
                f"block {block.header.number}: data hash mismatch")

        md = block.metadata.metadata if block.metadata else []
        idx = m.BlockMetadataIndex.SIGNATURES
        if len(md) <= idx or not md[idx]:
            raise BlockVerificationError(
                f"block {block.header.number}: no signature metadata")
        try:
            meta = m.Metadata.decode(md[idx])
        except Exception as e:
            raise BlockVerificationError(f"bad signature metadata: {e}")
        sds = []
        for sig in meta.signatures:
            try:
                sh = m.SignatureHeader.decode(sig.signature_header)
            except Exception:
                continue
            sds.append(SignedData(
                data=block_signed_data(block, meta.value,
                                       sig.signature_header),
                identity=sh.creator, signature=sig.signature))
        if not sds:
            raise BlockVerificationError(
                f"block {block.header.number}: no usable signatures")

        pol = self._bundle().policy(CHANNEL_ORDERER_BLOCK_VALIDATION)
        if pol is None:
            raise BlockVerificationError(
                "no orderer BlockValidation policy in channel config")
        verify_many = (self._verifier.verify_many
                       if self._verifier is not None else None)
        if not pol.evaluate_signed_data(sds, verify_many):
            raise BlockVerificationError(
                f"block {block.header.number}: signature set does not "
                f"satisfy BlockValidation policy")
