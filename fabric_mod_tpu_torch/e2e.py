"""In-process end-to-end network: the whole loop in one process.

The port's copy of fabric_mod_tpu/e2e.py `Network` (:41) and
`run_pipeline` (:208) (reference: the integration/nwo network builder,
network.go:44-60, shrunk to one process): client -> endorsers ->
Broadcast.submit -> solo consenter -> block cutting and signing ->
DeliverService -> the peer's MCS block-signature verify -> the
pipelined TxValidator -> MVCC -> the ledger commit.

On a card the two device paths of the loop are the MCS (one verify per
block) and the validator (every creator and endorser signature of a
block in one batch, and with `tensor_policy` the endorsement policies
on the device mask).  Ingress and the endorsers verify on the host (see
orderer/msgprocessor.py and peer/endorser.py).

A Network is built from `NetworkMaterial`: the CA certificates, the
signers' certificates and keys, and the genesis block, all as bytes —
from `utils/fixtures.make_network_material(seed)`, or carried across
from the JAX package's Network by `convert.network_material_from_reference`.
The chaincode registry holds `mycc` as the KvContract; the lifecycle
ceremony (`deploy_chaincode`) is not ported.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.msp.identities import SigningIdentity, deserialize_cert
from fabric_mod_tpu_torch.orderer import Broadcast, DeliverService, Registrar
from fabric_mod_tpu_torch.peer.chaincode import ChaincodeRegistry, KvContract
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
from fabric_mod_tpu_torch.peer.endorser import Endorser
from fabric_mod_tpu_torch.protos import messages as m

# (mspid, certificate PEM, PKCS#8 private-key PEM)
SignerPems = Tuple[str, bytes, bytes]


@dataclasses.dataclass
class NetworkMaterial:
    """A network's crypto material and genesis block, as bytes: each
    application org's CA certificate PEM, the orderer org's, the
    signers (an Org1-style client of the first org, one peer and one
    admin per org, the orderer) and the encoded genesis block.  The
    genesis block fixes the channel id, the orgs and the batch
    configuration."""
    ca_pems: Dict[str, bytes]
    orderer_ca_pem: bytes
    client: SignerPems
    peers: Dict[str, SignerPems]
    admins: Dict[str, SignerPems]
    orderer: SignerPems
    genesis: bytes


def _signer(csp, pems: SignerPems) -> SigningIdentity:
    mspid, cert_pem, key_pem = pems
    return SigningIdentity(mspid, deserialize_cert(cert_pem), key_pem, csp)


class Network:
    """One channel, N orgs, one solo orderer, one committing peer, one
    endorser per org — all in-process, built from `material` (its
    genesis block fixes the channel, the orgs and the batch
    configuration).  `verifier` None builds `GpuVerifier(device=device)`:
    on CUDA unless `device="cpu"`, and it raises without a card."""

    def __init__(self, root_dir: str, material: NetworkMaterial,
                 verifier=None, device=None, tensor_policy: bool = False):
        if verifier is None:
            from fabric_mod_tpu_torch.bccsp.gpu import GpuVerifier
            verifier = GpuVerifier(device=device)
        self.csp = SwCSP()
        self.verifier = verifier
        self.orderer_signer = _signer(self.csp, material.orderer)
        self.peer_signers = {org: _signer(self.csp, p)
                             for org, p in material.peers.items()}
        self.admins = {org: _signer(self.csp, p)
                       for org, p in material.admins.items()}
        self.client = _signer(self.csp, material.client)
        self.genesis_block = m.Block.decode(material.genesis)
        channel_id, config = config_from_block(self.genesis_block)
        self.channel_id = channel_id

        # the ordering service: the Writers check of each envelope
        # verifies on the host (orderer/msgprocessor.py)
        self.registrar = Registrar(os.path.join(root_dir, "orderer"),
                                   self.orderer_signer, self.csp)
        self.support = self.registrar.create_channel(
            m.Block.decode(material.genesis))
        self.broadcast = Broadcast(self.registrar)
        self.deliver = DeliverService(self.support)

        # the committing peer
        self.ledger_mgr = LedgerManager(os.path.join(root_dir, "peer"))
        self.ledger = self.ledger_mgr.create_or_open(channel_id)
        self.channel = Channel(channel_id, self.ledger, verifier,
                               Bundle(channel_id, config, self.csp),
                               self.csp, tensor_policy=tensor_policy)
        if self.ledger.height == 0:
            self.channel.init_from_genesis(self.genesis_block)

        # chaincode + endorsers
        self.chaincodes = ChaincodeRegistry()
        self.chaincodes.register("mycc", KvContract())
        self.endorsers: Dict[str, Endorser] = {
            org: Endorser(self.channel, self.chaincodes, signer)
            for org, signer in self.peer_signers.items()}

    def deliver_client(self) -> DeliverClient:
        return DeliverClient(self.channel, self.deliver)

    def close(self) -> None:
        self.registrar.close()
        self.channel.close()
        self.ledger_mgr.close()


def commit_until(net: Network, want_txs: int, timeout: float,
                 feed: Optional[Callable[[], None]] = None,
                 idle_timeout_s: float = 30.0
                 ) -> Tuple[DeliverClient, int, float]:
    """Run a deliver client on a thread of its own until `want_txs` txs
    after genesis are committed, the client ends, or `timeout` passes
    after `feed`.  `feed`, if given, runs on the calling thread once the
    client has started (the broadcasts).  The client is then stopped and
    joined, and its error re-raised.  Returns the client (its stage,
    await, commit and MCS seconds), the count of txs committed, and the
    seconds from the client's start until the wait ended."""
    client = net.deliver_client()
    errors = []

    def pull():
        try:
            client.run(idle_timeout_s=idle_timeout_s)
        except Exception as e:              # re-raised below
            errors.append(e)
    runner = threading.Thread(target=pull, name="e2e-deliver", daemon=True)
    t0 = time.perf_counter()
    runner.start()
    try:
        if feed is not None:
            feed()
        deadline = time.monotonic() + timeout
        counted, committed = 1, 0
        while True:
            alive = runner.is_alive()       # read before the last count
            # each block is decoded once, however long the wait
            height = net.ledger.height
            for num in range(counted, height):
                committed += len(net.ledger.get_block_by_number(num).data.data)
            counted = height
            if committed >= want_txs or not alive \
                    or time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        span_s = time.perf_counter() - t0
    finally:
        client.stop()
        runner.join(timeout=120)
    if runner.is_alive():
        raise RuntimeError("the deliver client did not stop")
    if errors:
        raise errors[0]
    return client, committed, span_s


def run_pipeline(n_txs: int, verifier=None, stats: Optional[dict] = None,
                 tensor_policy: bool = False, device=None) -> float:
    """Endorse `n_txs` puts, broadcast them while the peer's deliver
    client runs, and commit them through the peer pipeline; committed
    tx/s over the ordering + commit span (endorsement and signing
    excluded: client work).  The network is
    `fixtures.make_network_material(0)`'s.

    `stats`, if given, receives the deliver client's cumulative
    stage_secs (host unpack + device dispatch), await_secs (the
    verdict wait) and commit_secs (await + resolve + MVCC + ledger
    commit), mcs_secs (the block-signature checks) and wall_secs (the
    measured span)."""
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    with tempfile.TemporaryDirectory() as root:
        net = Network(root, fixtures.make_network_material(0),
                      verifier=verifier, device=device,
                      tensor_policy=tensor_policy)
        try:
            envs = []
            orgs = list(net.endorsers)[:2]
            for i in range(n_txs):
                sp, prop, _ = protoutil.create_chaincode_proposal(
                    net.channel_id, "mycc",
                    [b"put", b"k%d" % i, b"v%d" % i], net.client)
                responses = [net.endorsers[o].process_proposal(sp)
                             for o in orgs]
                envs.append(protoutil.create_tx_from_responses(
                    prop, responses, net.client))

            def feed():
                for env in envs:
                    net.broadcast.submit(env)
            client, committed, dt = commit_until(
                net, n_txs, max(120.0, n_txs / 20), feed=feed)
            if committed < n_txs:
                raise RuntimeError(f"only {committed}/{n_txs} txs committed")
            if stats is not None:
                stats.update(stage_secs=client.stage_secs,
                             await_secs=client.await_secs,
                             commit_secs=client.commit_secs,
                             mcs_secs=client.mcs_secs, wall_secs=dt)
            return n_txs / dt
        finally:
            net.close()
