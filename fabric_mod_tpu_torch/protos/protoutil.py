"""Envelope/block/proposal construction and extraction helpers.

The equivalent of the reference's protoutil package (reference:
protoutil/commonutils.go, protoutil/proputils.go,
protoutil/blockutils.go, protoutil/signeddata.go, protoutil/txutils.go)
— every layer above builds and unpacks wire messages through here.

Hashing conventions (deterministic, but intentionally *not* byte-
compatible with the reference — this is a new framework, not a fork):
* tx_id = hex(sha256(nonce ‖ creator)) — same recipe as the ref.
* block data hash = sha256 over the concatenation of the block's tx
  envelope encodings.
* block header hash = sha256 of the header's wire encoding (the ref
  uses ASN.1 here; ours is the same deterministic proto encoding used
  everywhere else).
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from fabric_mod_tpu_torch.protos import messages as m


@dataclass(frozen=True)
class SignedData:
    """The universal (data, identity, signature) triple every policy
    check consumes (reference: protoutil/signeddata.go)."""
    data: bytes
    identity: bytes             # SerializedIdentity bytes
    signature: bytes


def compute_tx_id(nonce: bytes, creator: bytes) -> str:
    return hashlib.sha256(nonce + creator).hexdigest()


def new_nonce() -> bytes:
    return os.urandom(24)


def now_ns() -> int:
    return time.time_ns()


def make_channel_header(htype: int, channel_id: str, tx_id: str = "",
                        epoch: int = 0, extension: bytes = b"",
                        timestamp: Optional[int] = None) -> m.ChannelHeader:
    return m.ChannelHeader(type=htype, version=0,
                           timestamp=now_ns() if timestamp is None else timestamp,
                           channel_id=channel_id, tx_id=tx_id, epoch=epoch,
                           extension=extension)


def make_signature_header(creator: bytes, nonce: bytes) -> m.SignatureHeader:
    return m.SignatureHeader(creator=creator, nonce=nonce)


def make_payload(ch: m.ChannelHeader, sh: m.SignatureHeader,
                 data: bytes) -> m.Payload:
    return m.Payload(
        header=m.Header(channel_header=ch.encode(),
                        signature_header=sh.encode()),
        data=data)


def sign_envelope(payload: m.Payload, signer) -> m.Envelope:
    """signer: object with .sign_message(msg: bytes) -> bytes."""
    pb = payload.encode()
    return m.Envelope(payload=pb, signature=signer.sign_message(pb))


def unmarshal_envelope_payload(env: m.Envelope) -> m.Payload:
    return m.Payload.decode(env.payload)


def envelope_channel_header(env: m.Envelope) -> m.ChannelHeader:
    pl = m.Payload.decode(env.payload)
    return m.ChannelHeader.decode(pl.header.channel_header)


def envelope_as_signed_data(env: m.Envelope) -> List[SignedData]:
    """(reference: protoutil/signeddata.go EnvelopeAsSignedData)."""
    pl = m.Payload.decode(env.payload)
    sh = m.SignatureHeader.decode(pl.header.signature_header)
    return [SignedData(data=env.payload, identity=sh.creator,
                       signature=env.signature)]


# --- blocks ---------------------------------------------------------------

def create_signed_tx(channel_id: str, chaincode_ns: str,
                     results: bytes, creator, endorsers: Sequence,
                     response_payload: bytes = b"",
                     events: bytes = b"") -> m.Envelope:
    """Assemble a fully-signed endorser transaction
    (reference: protoutil/txutils.go CreateSignedTx).

    `creator` and each endorser are SigningIdentity-shaped (serialize()
    + sign_message()).  Each endorsement signs
    proposal-response-payload ‖ endorser-identity — exactly the
    signature-set data the validator reconstructs
    (statebased/validator_keylevel.go:245-258).
    """
    nonce = new_nonce()
    creator_bytes = creator.serialize()
    tx_id = compute_tx_id(nonce, creator_bytes)
    cca = m.ChaincodeAction(
        results=results, events=events,
        response=m.Response(status=200, payload=response_payload),
        chaincode_id=m.ChaincodeID(name=chaincode_ns))
    prp = m.ProposalResponsePayload(
        proposal_hash=hashlib.sha256(tx_id.encode()).digest(),
        extension=cca.encode())
    prp_bytes = prp.encode()
    endorsements = [
        m.Endorsement(endorser=e.serialize(),
                      signature=e.sign_message(prp_bytes + e.serialize()))
        for e in endorsers]
    cap = m.ChaincodeActionPayload(action=m.ChaincodeEndorsedAction(
        proposal_response_payload=prp_bytes, endorsements=endorsements))
    tx = m.Transaction(actions=[m.TransactionAction(payload=cap.encode())])
    ch = make_channel_header(m.HeaderType.ENDORSER_TRANSACTION,
                             channel_id, tx_id=tx_id)
    sh = make_signature_header(creator_bytes, nonce)
    payload = make_payload(ch, sh, tx.encode())
    return sign_envelope(payload, creator)


def block_data_hash(data: m.BlockData) -> bytes:
    h = hashlib.sha256()
    for d in data.data:
        h.update(d)
    return h.digest()


def block_header_hash(header: m.BlockHeader) -> bytes:
    return hashlib.sha256(header.encode()).digest()


def new_block(number: int, previous_hash: bytes,
              envelopes: Sequence[m.Envelope]) -> m.Block:
    data = m.BlockData(data=[e.encode() for e in envelopes])
    header = m.BlockHeader(number=number, previous_hash=previous_hash,
                           data_hash=block_data_hash(data))
    ntx = len(data.data)
    flags = bytes([m.TxValidationCode.NOT_VALIDATED] * ntx)
    meta = m.BlockMetadata(metadata=[b"", b"", flags, b"", b""])
    return m.Block(header=header, data=data, metadata=meta)


def block_txflags(block: m.Block) -> bytearray:
    """The per-tx validation-code bitmap stored in block metadata
    (reference: internal/pkg/txflags)."""
    md = block.metadata.metadata
    idx = m.BlockMetadataIndex.TRANSACTIONS_FILTER
    ntx = len(block.data.data)
    if len(md) > idx and len(md[idx]) == ntx:
        return bytearray(md[idx])
    return bytearray([m.TxValidationCode.NOT_VALIDATED] * ntx)


def set_block_txflags(block: m.Block, flags: bytes) -> None:
    md = block.metadata.metadata
    idx = m.BlockMetadataIndex.TRANSACTIONS_FILTER
    while len(md) <= idx:
        md.append(b"")
    md[idx] = bytes(flags)


def get_envelopes(block: m.Block) -> List[m.Envelope]:
    return [m.Envelope.decode(d) for d in block.data.data]


# --- transactions ----------------------------------------------------------

def extract_endorser_tx(payload: m.Payload) -> m.Transaction:
    return m.Transaction.decode(payload.data)


def tx_rwset_and_endorsements(action: m.TransactionAction):
    """Unpack one action -> (ChaincodeAction, prp_bytes, endorsements).

    prp_bytes is the exact ProposalResponsePayload encoding the
    endorsers signed over (together with the endorser identity) — the
    signature-set data for endorsement-policy checks (reference:
    core/common/validation/statebased/validator_keylevel.go:245-258).
    """
    cap = m.ChaincodeActionPayload.decode(action.payload)
    prp_bytes = cap.action.proposal_response_payload
    prp = m.ProposalResponsePayload.decode(prp_bytes)
    cca = m.ChaincodeAction.decode(prp.extension)
    return cca, prp_bytes, cap.action.endorsements


# --- proposals (the endorsement flow) --------------------------------------

def create_chaincode_proposal(channel_id: str, chaincode_ns: str,
                              args: Sequence[bytes], creator,
                              transient: "Optional[dict]" = None
                              ) -> "tuple[m.SignedProposal, m.Proposal, str]":
    """Client-side proposal construction + signature
    (reference: protoutil/proputils.go CreateChaincodeProposal +
    GetSignedProposal).  Returns (signed_proposal, proposal, tx_id).
    `transient` carries side-channel inputs (private data plaintext)
    that never reach the ordered transaction."""
    nonce = new_nonce()
    creator_bytes = creator.serialize()
    tx_id = compute_tx_id(nonce, creator_bytes)
    cis = m.ChaincodeInvocationSpec(chaincode_spec=m.ChaincodeSpec(
        chaincode_id=m.ChaincodeID(name=chaincode_ns),
        input=m.ChaincodeInput(args=list(args))))
    ext = m.ChaincodeHeaderExtension(
        chaincode_id=m.ChaincodeID(name=chaincode_ns))
    ch = make_channel_header(m.HeaderType.ENDORSER_TRANSACTION, channel_id,
                             tx_id=tx_id)
    ch.extension = ext.encode()
    sh = make_signature_header(creator_bytes, nonce)
    header = m.Header(channel_header=ch.encode(),
                      signature_header=sh.encode())
    ccpp = m.ChaincodeProposalPayload(
        input=cis.encode(),
        transient_map=[m.TransientMapEntry(key=k, value=v)
                       for k, v in sorted((transient or {}).items())])
    prop = m.Proposal(header=header.encode(), payload=ccpp.encode())
    prop_bytes = prop.encode()
    sp = m.SignedProposal(proposal_bytes=prop_bytes,
                          signature=creator.sign_message(prop_bytes))
    return sp, prop, tx_id


def create_tx_from_responses(prop: m.Proposal,
                             responses: "Sequence[m.ProposalResponse]",
                             creator) -> m.Envelope:
    """Assemble the transaction envelope from a proposal and the
    endorsers' responses (reference: protoutil/txutils.go
    CreateSignedTx — requires all response payloads identical)."""
    if not responses:
        raise ValueError("no proposal responses")
    prp_bytes = responses[0].payload
    for r in responses[1:]:
        if r.payload != prp_bytes:
            raise ValueError("proposal response payloads differ")
    for r in responses:
        if r.response is None or r.response.status != 200:
            raise ValueError("endorsement failed: "
                             f"{r.response.message if r.response else '?'}")
    header = m.Header.decode(prop.header)
    # strip the transient map: side-channel inputs (private data)
    # must never enter the ordered transaction (reference:
    # txutils.go's proposal-payload visibility handling)
    ccpp = m.ChaincodeProposalPayload.decode(prop.payload)
    clean_ccpp = m.ChaincodeProposalPayload(input=ccpp.input)
    cap = m.ChaincodeActionPayload(
        chaincode_proposal_payload=clean_ccpp.encode(),
        action=m.ChaincodeEndorsedAction(
            proposal_response_payload=prp_bytes,
            endorsements=[r.endorsement for r in responses]))
    tx = m.Transaction(actions=[m.TransactionAction(
        header=header.signature_header, payload=cap.encode())])
    payload = m.Payload(header=header, data=tx.encode())
    return sign_envelope(payload, creator)


def block_last_config_index(block: m.Block) -> "Optional[int]":
    """The last-config pointer from a committed block's SIGNATURES
    metadata, or None (reference: protoutil/blockutils.go
    GetLastConfigIndexFromBlock)."""
    md = block.metadata.metadata if block.metadata else []
    idx = m.BlockMetadataIndex.SIGNATURES
    if len(md) <= idx or not md[idx]:
        return None
    try:
        meta = m.Metadata.decode(md[idx])
        return m.LastConfig.decode(meta.value).index
    except Exception:
        return None


def seek_number(pos, height: int, newest_tip: bool):
    """Decode one SeekPosition against a chain height — the shared
    convention of every deliver surface (orderer AtomicBroadcast and
    the peer event service; reference: common/deliver/deliver.go:199).

    start positions (`newest_tip=True`): newest pins the current tip
    block, absent/unknown defaults to oldest.  stop positions: newest
    (or absent) means "no stop — stream forever"."""
    if pos is None:
        return None
    if pos.specified is not None:
        return pos.specified.number
    if pos.oldest is not None:
        return 0
    if pos.newest is not None:
        return max(0, height - 1) if newest_tip else None
    return None if not newest_tip else 0
