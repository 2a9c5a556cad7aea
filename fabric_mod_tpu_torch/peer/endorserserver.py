"""The peer's endorsement surface: Endorser/ProcessProposal over the wire.

The port's copy of fabric_mod_tpu/peer/endorserserver.py (reference:
core/endorser — the peer's ProcessProposal service at endorser.go:330,
registered by internal/peer/node/start.go:205 — and the client side the
chaincode CLI uses, internal/peer/chaincode/common.go's EndorserClient).

Wire contract: SignedProposal / ProposalResponse as this framework's
deterministic encodings over comm/grpc_comm's generic byte services.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from fabric_mod_tpu_torch.comm.grpc_comm import (GRPCClient, GRPCServer,
                                                 MethodKind)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

SERVICE = "protos.Endorser"


class EndorserServer:
    """Binds an in-process Endorser to an RPC listener; `grpc` shares one
    listener with the peer's other services (events), as the reference
    registers everything on the single peer server
    (internal/peer/node/start.go:205)."""

    def __init__(self, endorser, address: str = "127.0.0.1:0",
                 server_cert_pem: Optional[bytes] = None,
                 server_key_pem: Optional[bytes] = None,
                 client_root_pem: Optional[bytes] = None,
                 grpc: Optional[GRPCServer] = None):
        self._endorser = endorser
        self._owns_grpc = grpc is None
        self._grpc = grpc or GRPCServer(address, server_cert_pem,
                                        server_key_pem, client_root_pem)
        self.port = self._grpc.port
        self._grpc.register(SERVICE, "ProcessProposal",
                            MethodKind.UNARY, self._process)

    def start(self) -> None:
        if self._owns_grpc:
            self._grpc.start()

    def stop(self, grace: float = 1.0) -> None:
        if self._owns_grpc:
            self._grpc.stop(grace)

    def _process(self, request: bytes, _context) -> bytes:
        try:
            sp = m.SignedProposal.decode(request)
        except Exception as e:
            return m.ProposalResponse(response=m.Response(
                status=400, message=f"bad proposal: {e}")).encode()
        try:
            resp = self._endorser.process_proposal(sp)
        except Exception as e:
            resp = m.ProposalResponse(response=m.Response(
                status=500, message=str(e)))
        return resp.encode()


class RemoteEndorser:
    """The client-side view with the in-process Endorser's shape, so
    endorse_and_submit and the CLI do not depend on the transport
    (reference: the EndorserClient of internal/peer/common)."""

    def __init__(self, client: GRPCClient, timeout_s: float = 30.0):
        self._client = client
        self._timeout = timeout_s

    def process_proposal(self, sp: m.SignedProposal) -> m.ProposalResponse:
        raw = self._client.unary(SERVICE, "ProcessProposal",
                                 sp.encode(), timeout=self._timeout)
        return m.ProposalResponse.decode(raw)


def invoke_remote(channel_id: str, chaincode: str,
                  args: Sequence[bytes], client_signer,
                  endorsers: Sequence[RemoteEndorser], broadcaster,
                  transient=None) -> str:
    """proposal -> remote endorsements -> tx -> broadcast: the
    cross-process flavor of endorse_and_submit.  Raises if any
    endorsement failed."""
    sp, prop, tx_id = protoutil.create_chaincode_proposal(
        channel_id, chaincode, args, client_signer,
        transient=transient)
    # the endorsements are independent: gather them at once, so the
    # wall is the slowest peer's, not the sum
    with ThreadPoolExecutor(max_workers=max(1, len(endorsers))) as ex:
        responses = list(ex.map(
            lambda e: e.process_proposal(sp), endorsers))
    bad = [r for r in responses if r.response.status != 200]
    if bad:
        raise RuntimeError(
            f"endorsement failed: {bad[0].response.status} "
            f"{bad[0].response.message}")
    env = protoutil.create_tx_from_responses(prop, responses,
                                             client_signer)
    broadcaster.submit(env)
    return tx_id


def query_remote(channel_id: str, chaincode: str,
                 args: Sequence[bytes], client_signer,
                 endorser: RemoteEndorser) -> bytes:
    """Evaluate only: one endorsement, never ordered (reference: `peer
    chaincode query`)."""
    sp, _prop, _tx_id = protoutil.create_chaincode_proposal(
        channel_id, chaincode, args, client_signer)
    resp = endorser.process_proposal(sp)
    if resp.response.status != 200:
        raise RuntimeError(f"query failed: {resp.response.status} "
                           f"{resp.response.message}")
    return resp.response.payload
