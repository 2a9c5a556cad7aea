"""The endorser: simulate a proposal, sign the result.

The port's copy of fabric_mod_tpu/peer/endorser.py `Endorser` (:29) and
`endorse_and_submit` (:159) (reference: core/endorser/endorser.go —
ProcessProposal :306, preProcess's signature and ACL checks :258,
SimulateProposal :182 — without the container launch, which the
in-process chaincode registry replaces).  The proposal's transient map
reaches the chaincode stub, and a simulation's plaintext private writes
are staged in the channel's transient store under the tx id (:108-130),
and a contract's chaincode event rides in the ChaincodeAction's
`events` (:132-140).

The proposal's creator signature and its Writers ACL check verify on
the host: one proposal is one signature, and a device call per proposal
would pay the verify core's fixed launch cost every time (the same
reason the orderer's Writers check stays on the host,
orderer/msgprocessor.py).  Signing is host work too.
"""
from __future__ import annotations

import hashlib
from typing import Sequence

from fabric_mod_tpu_torch.peer.chaincode import ChaincodeRegistry, ChaincodeStub
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.policy.manager import CHANNEL_APPLICATION_WRITERS
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils.semaphore import AcquireTimeout, Semaphore

# how long a proposal waits for a permit under max_concurrency (the
# reference's endorser.go:93)
ACQUIRE_TIMEOUT_S = 5.0


class ProposalRejectedError(Exception):
    pass


class Endorser:
    """One peer's endorsement service for one channel."""

    def __init__(self, channel: Channel, registry: ChaincodeRegistry,
                 signer, max_concurrency: int = 0):
        """`max_concurrency` > 0 caps in-flight ProcessProposal calls
        (reference: internal/peer/node/grpc_limiters.go's Endorser
        semaphore); excess requests shed after a short wait with a 503
        response."""
        self._channel = channel
        self._registry = registry
        self._signer = signer
        self._limiter = (Semaphore(max_concurrency) if max_concurrency > 0
                         else None)

    # -- request preprocessing (reference: endorser.go:258 preProcess) --
    def _pre_process(self, sp: m.SignedProposal):
        try:
            prop = m.Proposal.decode(sp.proposal_bytes)
            header = m.Header.decode(prop.header)
            ch = m.ChannelHeader.decode(header.channel_header)
            sh = m.SignatureHeader.decode(header.signature_header)
        except Exception as e:
            raise ProposalRejectedError(f"malformed proposal: {e}") from e
        if ch.type != m.HeaderType.ENDORSER_TRANSACTION:
            raise ProposalRejectedError(f"bad header type {ch.type}")
        if ch.channel_id != self._channel.channel_id:
            raise ProposalRejectedError(
                f"proposal for channel {ch.channel_id!r}")
        if ch.tx_id != protoutil.compute_tx_id(sh.nonce, sh.creator):
            raise ProposalRejectedError("tx id does not bind nonce+creator")

        bundle = self._channel.bundle()
        try:
            creator = bundle.msp_manager.deserialize_identity(sh.creator)
            bundle.msp_manager.validate(creator)
        except Exception as e:
            raise ProposalRejectedError(f"bad creator: {e}") from e
        if not creator.verify(sp.proposal_bytes, sp.signature):
            raise ProposalRejectedError("creator signature invalid")

        # ACL: proposals need the channel's application Writers policy
        # (reference: aclmgmt PROPOSE -> /Channel/Application/Writers)
        pol = bundle.policy(CHANNEL_APPLICATION_WRITERS)
        if pol is None:
            raise ProposalRejectedError("no application Writers policy")
        sd = protoutil.SignedData(data=sp.proposal_bytes,
                                  identity=sh.creator,
                                  signature=sp.signature)
        if not pol.evaluate_signed_data([sd]):
            raise ProposalRejectedError("ACL check failed (Writers)")

        if self._channel.ledger.tx_id_exists(ch.tx_id):
            raise ProposalRejectedError(f"duplicate tx id {ch.tx_id}")
        return prop, ch, sh

    # -- the endorsement flow (reference: endorser.go:306) ---------------
    def process_proposal(self, sp: m.SignedProposal) -> m.ProposalResponse:
        if self._limiter is not None:
            try:
                with self._limiter.acquire(timeout_s=ACQUIRE_TIMEOUT_S):
                    return self._process_proposal(sp)
            except AcquireTimeout as e:
                return m.ProposalResponse(response=m.Response(
                    status=503, message=f"endorser overloaded: {e}"))
        return self._process_proposal(sp)

    def _process_proposal(self, sp: m.SignedProposal) -> m.ProposalResponse:
        prop, ch, sh = self._pre_process(sp)
        try:
            ccpp = m.ChaincodeProposalPayload.decode(prop.payload)
            cis = m.ChaincodeInvocationSpec.decode(ccpp.input)
            spec = cis.chaincode_spec
            ns = spec.chaincode_id.name
            args = list(spec.input.args) if spec.input else []
            transient = {e.key: e.value for e in ccpp.transient_map}
        except Exception as e:
            raise ProposalRejectedError(f"bad chaincode payload: {e}") from e

        # simulate against the current state (reference: :182
        # SimulateProposal over a tx simulator with read-your-writes)
        sim = self._channel.ledger.new_tx_simulator(ch.tx_id)
        stub = ChaincodeStub(ns, sim, args, ch.tx_id,
                             self._channel.channel_id, transient=transient,
                             creator=sh.creator)
        try:
            result = self._registry.execute(ns, stub)
            rwset = sim.done()
            pvt = sim.done_pvt()
        except Exception as e:
            return m.ProposalResponse(
                response=m.Response(status=500, message=str(e)))
        if pvt is not None:
            # stage the plaintext private writes for the commit path
            self._channel.transient_store.persist(
                ch.tx_id, self._channel.ledger.height, pvt)

        events = b""
        if stub.event is not None:
            # the contract's one chaincode event (shim SetEvent); a tx
            # without one keeps the empty field, byte for byte
            events = m.ChaincodeEvent(
                chaincode_id=ns, tx_id=ch.tx_id, event_name=stub.event[0],
                payload=stub.event[1]).encode()
        cca = m.ChaincodeAction(
            results=rwset.encode(),
            events=events,
            response=m.Response(status=200, payload=result),
            chaincode_id=m.ChaincodeID(name=ns))
        prp = m.ProposalResponsePayload(
            proposal_hash=hashlib.sha256(sp.proposal_bytes).digest(),
            extension=cca.encode())
        prp_bytes = prp.encode()
        endorser_bytes = self._signer.serialize()
        endorsement = m.Endorsement(
            endorser=endorser_bytes,
            signature=self._signer.sign_message(
                prp_bytes + endorser_bytes))
        return m.ProposalResponse(
            version=1,
            response=m.Response(status=200, payload=result),
            payload=prp_bytes,
            endorsement=endorsement)


def endorse_and_submit(channel_id: str, chaincode_ns: str,
                       args: Sequence[bytes], client_signer,
                       endorsers: Sequence[Endorser], broadcast,
                       transient=None) -> str:
    """Client convenience: proposal (with its `transient` map) -> N
    endorsements -> tx envelope -> broadcast; returns the tx id."""
    sp, prop, tx_id = protoutil.create_chaincode_proposal(
        channel_id, chaincode_ns, args, client_signer, transient=transient)
    responses = [e.process_proposal(sp) for e in endorsers]
    env = protoutil.create_tx_from_responses(prop, responses, client_signer)
    broadcast.submit(env)
    return tx_id
