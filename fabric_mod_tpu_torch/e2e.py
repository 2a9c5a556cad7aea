"""In-process end-to-end network: the whole loop in one process.

The port's copy of fabric_mod_tpu/e2e.py `Network` (:41) and
`run_pipeline` (:208) (reference: the integration/nwo network builder,
network.go:44-60, shrunk to one process): client -> endorsers ->
Broadcast.submit -> the consenter (solo, or three Raft orderers with
forwarding to the leader) -> block cutting and signing ->
DeliverService -> the peer's MCS block-signature verify -> the
pipelined TxValidator -> MVCC -> the ledger commit.

On a card the device paths of the loop are the MCS (one verify per
block), the validator (every creator and endorser signature of a block
in one batch, and with `tensor_policy` the endorsement policies on the
device mask) and, with `ingress_batching`, ingress: the orderer's
Writers checks go through a `BatchingVerifyService` over the same
verifier, and with `staged_batch` > 0 concurrent submitters' checks
coalesce into one call per lane drain (orderer/stagedbroadcast.py).
Otherwise ingress verifies on the host, as do the endorsers (see
orderer/msgprocessor.py and peer/endorser.py).

A Network is built from `NetworkMaterial`: the CA certificates, the
signers' certificates and keys, and the genesis block, all as bytes —
from `utils/fixtures.make_network_material(seed)`, or carried across
from the JAX package's Network by `convert.network_material_from_reference`.
The chaincode registry is peer/scc.py's `build_default_registry`:
`mycc` as the KvContract, the `_lifecycle` contract over the channel's
application orgs, QSCC and CSCC.  `Network.invoke` (:123) endorses and
broadcasts one proposal, its `transient` map carrying private plaintext
that never reaches the ordered tx; `deploy_chaincode` (:154) runs the
lifecycle ceremony (an org-local approval by each approving org's
admin, then the commit) and `update_config` signs and broadcasts a
config update computed by channelconfig's `compute_update`.  The peer's
ledger is a durable KvLedger opened through its LedgerManager, as in
the reference.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import (Bundle, compute_update,
                                                config_from_block,
                                                signed_update_envelope)
from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.msp.identities import SigningIdentity, deserialize_cert
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.orderer import (Broadcast, DeliverService,
                                          RaftChain, RaftTransport,
                                          Registrar)
from fabric_mod_tpu_torch.orderer.admission import AdmissionController
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
from fabric_mod_tpu_torch.peer.endorser import Endorser, endorse_and_submit
from fabric_mod_tpu_torch.peer.lifecycle import LIFECYCLE_NS
from fabric_mod_tpu_torch.peer.scc import build_default_registry
from fabric_mod_tpu_torch.protos import messages as m

# (mspid, certificate PEM, PKCS#8 private-key PEM)
SignerPems = Tuple[str, bytes, bytes]
# how long a Raft network's constructor waits for its first leader
LEADER_TIMEOUT_S = 60.0


@dataclasses.dataclass
class NetworkMaterial:
    """A network's crypto material and genesis block, as bytes: each
    application org's CA certificate PEM, the orderer org's, the
    signers (an Org1-style client of the first org, one peer and one
    admin per org, the orderer) and the encoded genesis block.  The
    genesis block fixes the channel id, the orgs, the batch
    configuration and the consensus type.  An etcdraft genesis lists
    its consenter ids, and `consenters` maps each to its orderer
    signer (`orderer` is then the first's).  `gossip_peers` are peer
    signers for the gossip peers a caller composes around the network
    (each a ledger, a Channel and a gossip.GossipNode of its own).
    `orderer_admin`, an admin of the orderer org, signs config updates
    of the orderer group (its mod_policy is the orderer org's Admins)."""
    ca_pems: Dict[str, bytes]
    orderer_ca_pem: bytes
    client: SignerPems
    peers: Dict[str, SignerPems]
    admins: Dict[str, SignerPems]
    orderer: SignerPems
    genesis: bytes
    consenters: Dict[str, SignerPems] = dataclasses.field(
        default_factory=dict)
    gossip_peers: List[SignerPems] = dataclasses.field(default_factory=list)
    orderer_admin: Optional[SignerPems] = None


def _signer(csp, pems: SignerPems) -> SigningIdentity:
    mspid, cert_pem, key_pem = pems
    return SigningIdentity(mspid, deserialize_cert(cert_pem), key_pem, csp)


@dataclasses.dataclass
class OrdererNode:
    """One ordering node of the network: its registrar and the channel's
    chain support on it, its Broadcast, and with ingress batching its
    own BatchingVerifyService."""
    id: str
    registrar: Registrar
    support: object
    broadcast: Broadcast
    ingress_service: object = None


class Network:
    """One channel, N orgs, the ordering service, one committing peer,
    one endorser per org — all in-process, built from `material` (its
    genesis block fixes the channel, the orgs, the batch configuration
    and the consensus type).  `verifier` None builds
    `GpuVerifier(device=device)`: on CUDA unless `device="cpu"`, and it
    raises without a card.  `ingress_batching` sends each orderer's
    Writers checks through a `BatchingVerifyService` of its own over
    `verifier` (one card stands in for each node's); `staged_batch` > 0
    stages Broadcast's normal txs in lanes that drain up to that many at
    a time (reference e2e.py:85-97).  Behind lanes the service flushes
    with no deadline wait: a lane's drain is already the cohort.

    A solo genesis gets one solo orderer.  An etcdraft genesis gets one
    orderer per consenter, each a Registrar whose chain is a RaftChain,
    all over one in-process RaftTransport (reference:
    soak/world.py:386-411); `election_timeout`, `heartbeat_s` and
    `clock` are the RaftChains' (the defaults are the reference's).  The
    constructor waits up to LEADER_TIMEOUT_S until one leader is elected
    and known to every node: with a manual clock, the caller advances it
    meanwhile.  The peer delivers from the first orderer;
    `orderers` lists them all, and `registrar`, `support`, `broadcast`
    and `ingress_service` are the first's.

    `admission`: the keyword arguments of
    orderer/admission.AdmissionController (queue_cap, rate, burst,
    shed_high, shed_low, shed_lat_s, clock); each orderer builds its own
    controller from them for its Broadcast, and `queue_cap` bounds its
    chains' submit queues.  None (the default) is every mechanism off:
    the blocking 10,000-entry queues, no limiter, no gate.

    `consenters` maps more ConsensusTypes to chain factories for every
    orderer's registrar (e.g. {"kafka": lambda support:
    BrokerChain(broker, support)}, orderer/broker.py); a type it does
    not name runs solo.  `pipeline_depth` > 0 gives the peer's Channel a
    shared commit pipe of that depth (peer/channel.py)."""

    def __init__(self, root_dir: str, material: NetworkMaterial,
                 verifier=None, device=None, tensor_policy: bool = False,
                 ingress_batching: bool = False, staged_batch: int = 0,
                 election_timeout: Tuple[float, float] = (0.15, 0.3),
                 heartbeat_s: float = 0.05, clock=None,
                 admission: Optional[dict] = None,
                 consenters: Optional[dict] = None,
                 pipeline_depth: int = 0):
        if verifier is None:
            from fabric_mod_tpu_torch.bccsp.gpu import GpuVerifier
            verifier = GpuVerifier(device=device)
        self.csp = SwCSP()
        self.verifier = verifier
        self.admission = dict(admission or {})
        self._consenters = dict(consenters or {})
        self._queue_cap = int(self.admission.get("queue_cap", 0))
        self.peer_signers = {org: _signer(self.csp, p)
                             for org, p in material.peers.items()}
        self.admins = {org: _signer(self.csp, p)
                       for org, p in material.admins.items()}
        self.client = _signer(self.csp, material.client)
        self.orderer_admin = (_signer(self.csp, material.orderer_admin)
                              if material.orderer_admin else None)
        self.root_dir = root_dir
        self.material = material
        self._raft_timing = (election_timeout, heartbeat_s, clock)
        self._ingress = (ingress_batching, staged_batch)
        self.genesis_block = m.Block.decode(material.genesis)
        channel_id, config = config_from_block(self.genesis_block)
        self.channel_id = channel_id
        bundle = Bundle(channel_id, config, self.csp)
        self.consensus_type = bundle.orderer.consensus_type

        # the ordering service: solo, or one node per Raft consenter
        self.orderers: List[OrdererNode] = []
        self.transport = None
        try:
            if self.consensus_type == "etcdraft":
                ids = list(bundle.orderer.consenters())
                if not ids or set(ids) - set(material.consenters):
                    raise ValueError("the etcdraft genesis needs a signer "
                                     "for each of its consenters")
                self.transport = RaftTransport()
                for oid in ids:
                    self.orderers.append(self._boot_orderer(
                        root_dir, oid, material.consenters[oid],
                        ingress_batching, staged_batch,
                        self._raft_factory(root_dir, oid, ids,
                                           election_timeout, heartbeat_s,
                                           clock)))
                self._wait_leader(LEADER_TIMEOUT_S)
            else:
                self.orderers.append(self._boot_orderer(
                    root_dir, "orderer", material.orderer,
                    ingress_batching, staged_batch, None))
        except BaseException:
            self._close_orderers()
            raise
        first = self.orderers[0]
        self.registrar = first.registrar
        self.support = first.support
        self.broadcast = first.broadcast
        self.ingress_service = first.ingress_service
        self.deliver = DeliverService(self.support)

        # the committing peer
        self.ledger_mgr = LedgerManager(os.path.join(root_dir, "peer"))
        self.ledger = self.ledger_mgr.create_or_open(channel_id)
        self.channel = Channel(channel_id, self.ledger, verifier, bundle,
                               self.csp, tensor_policy=tensor_policy,
                               pipeline_depth=pipeline_depth)
        if self.ledger.height == 0:
            self.channel.init_from_genesis(self.genesis_block)

        # the user contract, the system chaincodes and the endorsers
        self.chaincodes = build_default_registry(self.channel, self.ledger)
        self.endorsers: Dict[str, Endorser] = {
            org: Endorser(self.channel, self.chaincodes, signer)
            for org, signer in self.peer_signers.items()}

    def invoke(self, args: Sequence[bytes],
               endorsing_orgs: Optional[Sequence[str]] = None,
               chaincode: str = "mycc", transient=None,
               signer=None) -> str:
        """Endorse `args` to `chaincode` on `endorsing_orgs`' endorsers
        (the first two orgs by default) as `signer` (the client by
        default), with the `transient` map, and broadcast the tx;
        returns its tx id."""
        orgs = list(endorsing_orgs or list(self.endorsers)[:2])
        return endorse_and_submit(
            self.channel_id, chaincode, args, signer or self.client,
            [self.endorsers[o] for o in orgs], self.broadcast,
            transient=transient)

    def committed_txs(self) -> int:
        """The txs in the peer's blocks after genesis."""
        return sum(len(self.ledger.get_block_by_number(i).data.data)
                   for i in range(1, self.ledger.height))

    def pump_committed(self, want_txs: int, timeout: float = 30.0) -> int:
        """Run a deliver client until `want_txs` txs after genesis are
        committed (or `timeout` passes); returns the count."""
        return commit_until(self, want_txs, timeout, idle_timeout_s=5.0)[1]

    def deploy_chaincode(self, name: str, version: str, sequence: int,
                         policy: bytes = b"", collections: bytes = b"",
                         approving_orgs: Optional[Sequence[str]] = None
                         ) -> int:
        """The lifecycle ceremony (reference e2e.py:154): each approving
        org's admin submits an approval endorsed by its own peer (an
        org-local act) and it commits, in its own block, then the commit
        op (endorsed by the first two orgs) commits.  Every ceremony tx
        must be VALID, checked by tx id.  Returns the count of txs
        committed after genesis."""
        orgs = list(approving_orgs
                    or list(self.endorsers)[:len(self.endorsers) // 2 + 1])
        base = self.committed_txs()
        args = [name.encode(), version.encode(), str(sequence).encode(),
                policy, collections]
        txids = []
        for i, org in enumerate(orgs):
            txids.append(self.invoke([b"approve"] + args,
                                     endorsing_orgs=[org],
                                     chaincode=LIFECYCLE_NS,
                                     signer=self.admins[org]))
            got = self.pump_committed(base + i + 1)
            if got < base + i + 1:
                raise RuntimeError(
                    f"approvals did not commit ({got}/{base + i + 1})")
        txids.append(self.invoke([b"commit"] + args, chaincode=LIFECYCLE_NS))
        got = self.pump_committed(base + len(orgs) + 1)
        if got < base + len(orgs) + 1:
            raise RuntimeError("definition commit did not commit")
        # by tx id, not by position: other txs may share these blocks
        for txid in txids:
            pt = self.ledger.get_transaction_by_id(txid)
            if pt is None or pt.validation_code != m.TxValidationCode.VALID:
                raise RuntimeError(
                    f"lifecycle tx {txid} invalid "
                    f"({None if pt is None else pt.validation_code})")
        return got

    def update_config(self, desired_config: m.Config, signers) -> m.Envelope:
        """Compute the config update from the channel's current config to
        `desired_config`, sign it by `signers` (SigningIdentities, the
        first also signing the envelope) and broadcast it; returns the
        CONFIG_UPDATE envelope."""
        update = compute_update(self.channel_id, self.channel.bundle().config,
                                desired_config.channel_group)
        env = signed_update_envelope(self.channel_id, update, signers)
        self.broadcast.submit(env)
        return env

    def _raft_factory(self, root_dir, oid, ids, election_timeout,
                      heartbeat_s, clock, block_fetcher=None):
        def factory(support):
            return RaftChain(
                oid, list(ids), self.transport,
                os.path.join(root_dir, "orderer", oid,
                             f"{support.channel_id}.wal"),
                support, election_timeout=election_timeout,
                heartbeat_s=heartbeat_s, clock=clock,
                block_fetcher=block_fetcher,
                submit_queue_cap=support.submit_queue_cap)
        return factory

    def _boot_orderer(self, root_dir, oid, pems, ingress_batching,
                      staged_batch, raft_factory, join=None) -> OrdererNode:
        """One ordering node: the Writers check verifies on the host, or
        with ingress batching through its own coalescing service; the
        registrar picks the chain by the genesis' consensus type.
        `join` (join block, as_follower, fetcher): the node joins the
        channel by participation instead of creating it."""
        service = ingress_verify = None
        if ingress_batching:
            from fabric_mod_tpu_torch.bccsp.gpu import BatchingVerifyService
            service = (BatchingVerifyService(self.verifier, deadline_s=0.0)
                       if staged_batch else
                       BatchingVerifyService(self.verifier))
            ingress_verify = service.verify_many
        try:
            registrar = Registrar(
                os.path.join(root_dir, "orderer", oid),
                _signer(self.csp, pems), self.csp,
                verify_many=ingress_verify,
                consenters=dict(self._consenters, **(
                    {"etcdraft": raft_factory} if raft_factory else {})),
                submit_queue_cap=self._queue_cap,
                block_fetcher=join[2] if join else None,
                verifier=self.verifier)
        except BaseException:
            if service is not None:
                service.close()
            raise
        try:
            support = registrar.get_chain(self.channel_id)
            if support is None and join is not None:
                from fabric_mod_tpu_torch.orderer.participation import \
                    ChannelParticipation
                support = ChannelParticipation(registrar).join(
                    join[0], as_follower=join[1])
            elif support is None:
                support = registrar.create_channel(self.genesis_block)
        except BaseException:
            registrar.close()
            if service is not None:
                service.close()
            raise
        adm = (AdmissionController(**self.admission) if self.admission
               else None)
        return OrdererNode(oid, registrar, support,
                           Broadcast(registrar, staged_batch=staged_batch,
                                     admission=adm),
                           service)

    def join_orderer(self, oid: str, join_block: m.Block,
                     as_follower: bool = False) -> OrdererNode:
        """Boot one more ordering node, `oid` (its signer from the
        material's `consenters`), that joins the channel from
        `join_block` by channel participation (orderer/participation.py):
        from a genesis block, or from a later config block by
        replicating the first orderer's chain and checking every block
        through the MCS with the network's verifier.  A member of the
        Raft consenter set then runs a RaftChain over the network's
        transport (the cluster replicates to it); `as_follower` stores
        and follows the first orderer's blocks without ordering.  The
        node joins `orderers` and closes with the network."""
        from fabric_mod_tpu_torch.orderer.participation import (
            ChannelParticipation, store_fetcher)
        fetch = store_fetcher(self.orderers[0].support.store)
        election_timeout, heartbeat_s, clock = self._raft_timing
        raft_factory = None
        if self.transport is not None:
            raft_factory = self._raft_factory(
                self.root_dir, oid, [oid], election_timeout, heartbeat_s,
                clock, block_fetcher=fetch)
        node = self._boot_orderer(
            self.root_dir, oid, self.material.consenters[oid],
            *self._ingress, raft_factory, join=(join_block, as_follower,
                                                fetch))
        self.orderers.append(node)
        return node

    def raft_leader(self) -> Optional[str]:
        """The id of the one Raft leader every consenter knows, or None
        (an election in flight, or a solo network); followers of the
        channel are not asked."""
        if self.transport is None:
            return None
        members = [o for o in self.orderers
                   if hasattr(o.support.chain, "is_leader")]
        chains = [o.support.chain for o in members]
        leaders = [o.id for o, c in zip(members, chains) if c.is_leader]
        if len(leaders) != 1 or any(c.leader_id != leaders[0]
                                    for c in chains):
            return None
        return leaders[0]

    def _wait_leader(self, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        while self.raft_leader() is None:
            if time.monotonic() >= deadline:
                raise RuntimeError(f"no Raft leader elected within "
                                   f"{timeout_s} s")
            time.sleep(0.01)

    def deliver_client(self) -> DeliverClient:
        return DeliverClient(self.channel, self.deliver)

    def _close_orderers(self) -> None:
        """Stop the broadcast lanes (no submitter is left blocked) and
        the ingress services, halt every chain, then close the stores."""
        for o in self.orderers:
            o.broadcast.close()
            if o.ingress_service is not None:
                o.ingress_service.close()
        for o in self.orderers:
            o.support.halt()
        for o in self.orderers:
            o.registrar.close()

    def close(self) -> None:
        """Stop, in order: the ordering service (lanes, ingress
        services, every chain, then the stores), the peer's channel and
        the ledger."""
        self._close_orderers()
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
    runner = RegisteredThread(target=pull, name="e2e-deliver", structure="e2e")
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


def submit_all(net: Network, envs, submitters: int = 1) -> None:
    """Broadcast `envs` from `submitters` threads (envelope i from thread
    i mod submitters, each in order); the first error is re-raised."""
    if submitters <= 1:
        for env in envs:
            net.broadcast.submit(env)
        return
    errors = []

    def run(share):
        try:
            for env in share:
                net.broadcast.submit(env)
        except Exception as e:              # re-raised below
            errors.append(e)
    threads = [RegisteredThread(target=run, args=(envs[k::submitters],),
                                name=f"e2e-submit-{k}", structure="e2e")
               for k in range(submitters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a submitter did not finish")
    if errors:
        raise errors[0]


def run_pipeline(n_txs: int, verifier=None, stats: Optional[dict] = None,
                 tensor_policy: bool = False, device=None,
                 submitters: int = 1, staged_batch: int = 0,
                 ingress_batching: bool = False) -> float:
    """Endorse `n_txs` puts, broadcast them from `submitters` threads
    while the peer's deliver client runs, and commit them through the
    peer pipeline; committed tx/s over the ordering + commit span
    (endorsement and signing excluded: client work).  The network is
    `fixtures.make_network_material(0)`'s, with `staged_batch` and
    `ingress_batching` as `Network` takes them.

    `stats`, if given, receives the deliver client's cumulative
    stage_secs (host unpack + device dispatch), await_secs (the
    verdict wait) and commit_secs (await + resolve + MVCC + ledger
    commit), mcs_secs (the block-signature checks) and wall_secs (the
    measured span); with the tracer armed also `stage_attribution`,
    the seconds each named span took over the run (recv, unpack,
    der_marshal, device_dispatch, verdict_await, policy_*, mvcc,
    ledger_write, ...), as the reference's (:275-284)."""
    from fabric_mod_tpu_torch.protos import protoutil
    from fabric_mod_tpu_torch.utils import fixtures
    trace_t0 = ({k: v["secs"] for k, v in tracing.substage_totals().items()}
                if tracing.armed() else None)
    with tempfile.TemporaryDirectory() as root:
        net = Network(root, fixtures.make_network_material(0),
                      verifier=verifier, device=device,
                      tensor_policy=tensor_policy,
                      ingress_batching=ingress_batching,
                      staged_batch=staged_batch)
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

            client, committed, dt = commit_until(
                net, n_txs, max(120.0, n_txs / 20),
                feed=lambda: submit_all(net, envs, submitters))
            if committed < n_txs:
                raise RuntimeError(f"only {committed}/{n_txs} txs committed")
            if stats is not None:
                stats.update(stage_secs=client.stage_secs,
                             await_secs=client.await_secs,
                             commit_secs=client.commit_secs,
                             mcs_secs=client.mcs_secs, wall_secs=dt)
                if trace_t0 is not None:
                    stats["stage_attribution"] = {
                        k: round(v["secs"] - trace_t0.get(k, 0.0), 6)
                        for k, v in tracing.substage_totals().items()}
            return n_txs / dt
        finally:
            net.close()
