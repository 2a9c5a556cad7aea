"""The soak world: a full in-process network the churn plan perturbs.

The port's copy of fabric_mod_tpu/soak/world.py.  Its device work is
signature verification: where the reference builds its peers with a
host `FakeBatchVerifier`, every peer and channel here verifies through
ONE shared verifier — by default `GpuVerifier(device=device)`, on the
card unless `device="cpu"`, raising without a card as e2e.Network
does — so every block's MCS check and validation, every gossip
envelope, every config check, every event-stream ACL check and every
orderer's Writers check of a submitted tx runs the hand-written
kernels.  The reference's FMT_SOAK_SHARDED and
FMT_SOAK_RELAY knobs are the `sharded` and `relay` arguments.  The
audit subscription goes over the in-process event service
(peer/deliverevents.py) instead of a gRPC socket.

Topology:

  N raft orderers (ManualClock-driven elections, one RaftTransport per
  channel) x M channels, each orderer a Registrar + Broadcast;
  K gossiping peers, each with its own ledger/channel per soak channel,
  composed exactly like production: GossipNode (push + anti-entropy
  pull) + GossipService (election-owned DeliverClient) over a
  failover deliver source that rotates across LIVE orderers;
  one EventDeliverServer (in process) on peer p0 with the REAL
  bundle-backed ACLProvider, holding the audit org's standing
  BLOCK_UNTIL_READY subscription that an acl_revoke event must cut.

ManualClock acceleration: a pump thread advances fake time
continuously (default 2 fake-seconds per real second), so raft
elections/heartbeats run at fake speed while message passing, gossip,
and commit stay real-threaded — hours of election time compress into
a test's budget.

Orderer lifecycle primitives (`kill_orderer`, `add_consenter`,
`remove_consenter`) and config primitives (`revoke_audit_org`,
`set_batch_size`) are what the harness's event executor calls; each
goes through the REAL path: signed config updates through
Broadcast.submit -> msgprocessor -> chain.configure -> replicated
config blocks -> peer bundle swaps.
"""
from __future__ import annotations

import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

from fabric_mod_tpu_torch.bccsp.sw import SwCSP
from fabric_mod_tpu_torch.channelconfig import (Bundle, compute_update,
                                                genesis,
                                                signed_update_envelope)
from fabric_mod_tpu_torch.channelconfig.bundle import (APPLICATION,
                                                       BATCH_SIZE,
                                                       CONSENSUS_TYPE,
                                                       ORDERER, groups_of,
                                                       set_group, set_value,
                                                       values_of)
from fabric_mod_tpu_torch.channelconfig.configtx import config_from_block
from fabric_mod_tpu_torch.concurrency import (CancellationEvent,
                                              RegisteredThread,
                                              assert_joined)
from fabric_mod_tpu_torch.gossip import (GossipNode, GossipService,
                                         InProcNetwork)
from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
from fabric_mod_tpu_torch.msp import ca as calib
from fabric_mod_tpu_torch.msp.identities import SigningIdentity
from fabric_mod_tpu_torch.observability import get_logger
from fabric_mod_tpu_torch.orderer import Broadcast, DeliverService
from fabric_mod_tpu_torch.orderer.raft import RaftTransport
from fabric_mod_tpu_torch.orderer.raftchain import RaftChain
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.peer.aclmgmt import ACLProvider
from fabric_mod_tpu_torch.peer.channel import Channel
from fabric_mod_tpu_torch.peer.deliverevents import (EventDeliverClient,
                                                     EventDeliverServer,
                                                     EventStreamError)
from fabric_mod_tpu_torch.peer.endorser import Endorser
from fabric_mod_tpu_torch.peer.scc import build_default_registry
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.utils.fakeclock import ManualClock

log = get_logger("soak.world")

AUDIT_ORG = "AuditOrg"


def _seeded_rng(seed: int, *parts: str) -> random.Random:
    h = seed & 0xFFFFFFFF
    for p in parts:
        h = zlib.crc32(p.encode(), h)
    return random.Random(h)


class _FailoverSource:
    """In-process deliver failover: the `blocks()` generator contract
    of DeliverService over whichever LIVE orderer currently has the
    blocks.  A stream that dies (killed orderer, idle timeout, or an
    injected `deliver.stream` fault) rotates to another orderer and
    re-seeks from the next needed block; the consumer sees one
    gap-free sequence."""

    def __init__(self, world: "SoakWorld", channel_id: str):
        self._world = world
        self._cid = channel_id
        self.rotations = 0

    def blocks(self, start: int = 0, stop: Optional[int] = None,
               stop_event: Optional[threading.Event] = None,
               timeout_s: float = 30.0):
        num = start
        while stop is None or num <= stop:
            if stop_event is not None and stop_event.is_set():
                return
            sup = self._world.pick_deliver_support(self._cid, num)
            if sup is None:
                time.sleep(0.05)
                continue
            try:
                for blk in DeliverService(sup).blocks(
                        num, stop, stop_event=stop_event, timeout_s=1.0):
                    yield blk
                    num = blk.header.number + 1
            except Exception as e:
                # injected mid-stream fault or a dying orderer: the
                # rotation below is the tolerance mechanism under test
                log.debug("soak deliver stream rotating: %r", e)
            self.rotations += 1


class _Orderer:
    __slots__ = ("oid", "registrar", "broadcast", "signer", "dead",
                 "removed", "partitioned")

    def __init__(self, oid, registrar, broadcast, signer):
        self.oid = oid
        self.registrar = registrar
        self.broadcast = broadcast
        self.signer = signer
        self.dead = False
        self.removed = set()               # channels configured out
        # behind a network partition: raft messages black-holed and
        # clients route around it until the heal clears the flag
        self.partitioned = False


class SoakPeer:
    """One committing peer: a ledger + Channel + GossipNode +
    GossipService per soak channel, every channel on the world's
    shared verifier."""

    def __init__(self, world: "SoakWorld", name: str, org: str):
        self.name = name
        self.org = org
        self.world = world
        self.crashed = False
        cert, key = world.cas[org].issue(
            f"{name}.{org.lower()}", org, ous=["peer"])
        self.signer = SigningIdentity(org, cert, calib.key_pem(key),
                                      world.csp)
        self.ledger_mgr = LedgerManager(
            os.path.join(world.root, "peers", name))
        self.channels: Dict[str, Channel] = {}
        self.nodes: Dict[str, GossipNode] = {}
        self.services: Dict[str, GossipService] = {}
        # sharded-channel mode (`sharded`): this peer's channels place
        # onto slices behind one per-peer ChannelShardRouter — gossip
        # drains feed slice-pinned commit pipes and every MCS/config
        # verify rides the shared cross-channel service, so the seeded
        # churn exercises the sharding subsystem's placement and
        # isolation instead of the bare synchronous path
        self.router = None
        if world.sharded:
            from fabric_mod_tpu_torch.sharding import ChannelShardRouter
            self.router = ChannelShardRouter(
                n_slices=max(1, min(2, len(world.channel_ids))),
                verifier_factory=world.slice_verifier)
        self.relays: Dict[str, object] = {}
        for cid in world.channel_ids:
            ledger = self.ledger_mgr.create_or_open(cid)
            _, config = config_from_block(world.genesis[cid])
            verifier = (self.router.add_channel(cid)
                        if self.router is not None
                        else world.verifier)
            channel = Channel(cid, ledger, verifier,
                              Bundle(cid, config, world.csp), world.csp)
            if self.router is not None:
                channel.use_shard_router(self.router)
            if ledger.height == 0:
                channel.init_from_genesis(world.genesis[cid])
            self.channels[cid] = channel
            node = GossipNode(f"{name}.{cid}:7051", self.signer, channel,
                              world.networks[cid],
                              rng=_seeded_rng(world.seed, name, cid))
            self.nodes[cid] = node
            relay = None
            if world.relay:
                from fabric_mod_tpu_torch.dissemination import RelayService
                relay = RelayService(node)
                self.relays[cid] = relay
            self.services[cid] = GossipService(
                node, lambda cid=cid: _FailoverSource(world, cid),
                election_interval_s=0.2, relay=relay)

    def height(self, cid: str) -> int:
        return self.channels[cid].ledger.height

    def fingerprint(self, cid: str) -> str:
        return self.channels[cid].ledger.state_fingerprint()

    def start(self) -> None:
        for svc in self.services.values():
            svc.start()

    def stop(self) -> None:
        if getattr(self, "crashed", False):
            return                         # already hard-dropped
        for svc in self.services.values():
            svc.stop()
        for node in self.nodes.values():
            node.stop()
        for channel in self.channels.values():
            channel.close()
        if self.router is not None:
            # after the services' final drains: the router close joins
            # every slice-pinned pipe and the shared flusher before
            # the ledgers they write go away
            self.router.close()
        self.ledger_mgr.close()

    def crash(self) -> None:
        """Hard-drop: every registered thread is torn down (the leak
        sweep must stay clean — a crashed process has no threads) but
        the durable ledgers are ABANDONED, not closed: no checkpoint,
        no flush.  Whatever the per-block fsyncs already made durable
        survives on disk; buffered frames and in-flight commits are
        lost by design, and `KvLedger._recover` on the rejoined peer's
        reopen is what repairs the statedb-behind-blockstore window.
        The world retains a strong reference to this object (see
        `SoakWorld.crashed_peers`) so the abandoned append-mode
        handles are never GC-finalized — a finalizer flush would write
        stale buffered bytes under the rejoined peer's feet."""
        for svc in self.services.values():
            svc.stop()
        for node in self.nodes.values():
            node.stop()
        if self.router is not None:
            self.router.close()
        self.crashed = True


class _Subscriber:
    """The audit org's standing event-deliver subscription, over the
    in-process event service: collects received block numbers until
    the stream ends; an acl_revoke event must end it FORBIDDEN without
    a single post-revocation block."""

    def __init__(self, server: EventDeliverServer, channel_id: str,
                 signer):
        self._cancel = CancellationEvent()
        self._evc = EventDeliverClient(server.call, channel_id, signer)
        self.received: List[int] = []
        self.status: Optional[int] = None
        self.error: Optional[Exception] = None
        self._thread = RegisteredThread(target=self._run,
                                        name="soak-audit-subscriber",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for blk in self._evc.blocks(start=0, stop=None,
                                        timeout_s=3600.0,
                                        stop_event=self._cancel):
                self.received.append(blk.header.number)
        except EventStreamError as e:
            self.status = e.status
        except Exception as e:             # kept for the report
            self.error = e

    def done(self, timeout_s: float) -> bool:
        self._thread.join(timeout=timeout_s)
        return not self._thread.is_alive()

    def close(self) -> None:
        self._cancel.set()
        self._thread.join(timeout=10)


class SoakWorld:
    """`verifier`: the one verifier every peer, channel and orderer
    shares (blocks, MCS, gossip envelopes, config and ACL checks, the
    orderers' Writers checks); None builds
    `GpuVerifier(device=device)`, on the card unless `device="cpu"`.
    `sharded` (the reference's FMT_SOAK_SHARDED) routes every peer's
    channels through a per-peer ChannelShardRouter, whose slices are
    `GpuVerifier(device=device)`s (or `verifier`, when one is given:
    it then needs `verify_many_async` and `verify_many_fused_async`).
    `relay` (FMT_SOAK_RELAY) ships blocks down dissemination trees
    instead of the epidemic push."""

    def __init__(self, root: str, seed: int, n_channels: int = 2,
                 n_peers: int = 2, orgs=("Org1", "Org2"),
                 orderer_ids=("o0", "o1", "o2"),
                 max_message_count: int = 8,
                 batch_timeout: str = "200ms",
                 clock_step: float = 0.01,
                 clock_interval: float = 0.005,
                 verifier=None, device=None, sharded: bool = False,
                 relay: bool = False):
        self.root = str(root)
        self.seed = int(seed)
        self.csp = SwCSP()
        self.device = device
        self._given_verifier = verifier is not None
        if verifier is None:
            from fabric_mod_tpu_torch.bccsp.gpu import GpuVerifier
            verifier = GpuVerifier(device=device)
        self.verifier = verifier
        self.sharded = bool(sharded)
        # dissemination-relay mode: every peer's channels ship blocks
        # down RelayTrees instead of the sqrt-N epidemic push, so churn
        # exercises reparenting and the anti-entropy repair seam
        self.relay = bool(relay)
        self.orgs = list(orgs)
        self.channel_ids = [f"soak{i}" for i in range(n_channels)]
        self.clock = ManualClock()
        self._clock_step = clock_step
        self._clock_interval = clock_interval
        self._pump_stop = threading.Event()
        self._pump: Optional[RegisteredThread] = None
        self._lock = threading.Lock()
        self._batch_counts: Dict[str, int] = {}
        self._rr = 0

        # crypto material: app orgs + the revocable audit org + orderer
        # (the port's CA derives every key from its seed)
        ca_seed = b"soak|%d" % self.seed
        self.cas = {org: calib.CA(f"ca.{org.lower()}", org, seed=ca_seed)
                    for org in self.orgs + [AUDIT_ORG]}
        self.orderer_ca = calib.CA("ca.orderer", "OrdererOrg",
                                   seed=ca_seed)
        self.admins: Dict[str, SigningIdentity] = {}
        for org in self.orgs + [AUDIT_ORG]:
            cert, key = self.cas[org].issue(
                f"admin@{org.lower()}", org, ous=["admin"])
            self.admins[org] = SigningIdentity(org, cert,
                                               calib.key_pem(key),
                                               self.csp)
        ocert, okey = self.orderer_ca.issue("admin@orderer", "OrdererOrg",
                                            ous=["admin"])
        self.orderer_admin = SigningIdentity(
            "OrdererOrg", ocert, calib.key_pem(okey), self.csp)
        ccert, ckey = self.cas[self.orgs[0]].issue(
            f"client@{self.orgs[0].lower()}", self.orgs[0],
            ous=["client"])
        self.client = SigningIdentity(self.orgs[0], ccert,
                                      calib.key_pem(ckey), self.csp)
        acert, akey = self.cas[AUDIT_ORG].issue(
            "auditor@audit", AUDIT_ORG, ous=["client"])
        self.audit_client = SigningIdentity(AUDIT_ORG, acert,
                                            calib.key_pem(akey), self.csp)

        # genesis per channel (multi-channel: one ledger per channel,
        # PAPER.md L3) — raft consenters declared in the config
        org_cas = {org: [calib.cert_pem(self.cas[org].cert)]
                   for org in self.orgs + [AUDIT_ORG]}
        ord_cas = {"OrdererOrg": [calib.cert_pem(self.orderer_ca.cert)]}
        self.genesis: Dict[str, m.Block] = {}
        self.transports: Dict[str, RaftTransport] = {}
        self.networks: Dict[str, InProcNetwork] = {}
        for cid in self.channel_ids:
            self.genesis[cid] = genesis.standard_network(
                cid, org_cas, ord_cas, consensus_type="etcdraft",
                consenters=list(orderer_ids),
                batch_timeout=batch_timeout,
                max_message_count=max_message_count)
            self.transports[cid] = RaftTransport()
            self.networks[cid] = InProcNetwork()
            self._batch_counts[cid] = max_message_count

        self.orderers: Dict[str, _Orderer] = {}
        self._bootstrap_ids = list(orderer_ids)
        # registrars replaced by restart_orderer: their stores' idle
        # handles are closed at world teardown, never mid-run
        self._retired_registrars: List[Registrar] = []
        for oid in orderer_ids:
            self._boot_orderer(oid)

        self.peers: List[SoakPeer] = []
        # hard-crashed SoakPeers, retained forever: dropping the last
        # reference would let GC finalize their abandoned append-mode
        # durable handles — a buffered-byte flush into files the
        # rejoined peer now owns
        self.crashed_peers: List[SoakPeer] = []
        # monotonically-issued peer names: a crash removes its victim
        # from self.peers, so len(self.peers) can no longer name
        # joiners without colliding with a crashed peer's dirs
        self._peer_seq = n_peers
        for i in range(n_peers):
            self.peers.append(SoakPeer(
                self, f"p{i}", self.orgs[i % len(self.orgs)]))

        # endorsers evaluate over p0's channel state (any replica
        # works — endorsement is a read-time act)
        self.endorsers: Dict[str, Dict[str, Endorser]] = {}
        p0 = self.peers[0]
        for cid in self.channel_ids:
            registry = build_default_registry(
                p0.channels[cid], p0.channels[cid].ledger)
            per_org = {}
            for org in self.orgs:
                cert, key = self.cas[org].issue(
                    f"endorser.{org.lower()}.{cid}", org, ous=["peer"])
                per_org[org] = Endorser(
                    p0.channels[cid], registry,
                    SigningIdentity(org, cert, calib.key_pem(key),
                                    self.csp))
            self.endorsers[cid] = per_org

        self.event_server: Optional[EventDeliverServer] = None
        self.subscriber: Optional[_Subscriber] = None

    def slice_verifier(self, index: int, mesh=None):
        """The sharded mode's slice verifier: a `GpuVerifier` on the
        world's device, or the given verifier."""
        if self._given_verifier:
            return self.verifier
        from fabric_mod_tpu_torch.bccsp.gpu import GpuVerifier
        return GpuVerifier(device=self.device)

    # -- orderer lifecycle -------------------------------------------------

    def _boot_orderer(self, oid: str) -> _Orderer:
        ocert, okey = self.orderer_ca.issue(
            f"{oid}.orderer", "OrdererOrg", ous=["orderer"])
        signer = SigningIdentity("OrdererOrg", ocert,
                                 calib.key_pem(okey), self.csp)
        root = os.path.join(self.root, "ord", oid)

        def factory(support, oid=oid):
            cid = support.channel_id
            return RaftChain(
                oid, list(self._bootstrap_ids), self.transports[cid],
                os.path.join(self.root, "ord", oid, f"{cid}.wal"),
                support, clock=self.clock,
                rng=_seeded_rng(self.seed, oid, cid))

        # the orderers' Writers checks go through the shared verifier
        # too (the reference's orderers verify on the host)
        reg = Registrar(root, signer, self.csp,
                        verify_many=self.verifier.verify_many,
                        chain_factory=factory)
        for cid in self.channel_ids:
            # a RESTART boots over existing dirs: the Registrar ctor
            # already recovered those channels (WAL replay + store
            # tip); only genuinely new dirs get the genesis block
            if reg.get_chain(cid) is None:
                reg.create_channel(self.genesis[cid])
        o = _Orderer(oid, reg, Broadcast(reg), signer)
        with self._lock:
            self.orderers[oid] = o
        return o

    def live_orderers(self) -> List[_Orderer]:
        with self._lock:
            return [o for o in self.orderers.values()
                    if not o.dead and not o.partitioned]

    def chains(self, cid: str) -> Dict[str, object]:
        """Live, still-configured-in chains for a channel."""
        out = {}
        for o in self.live_orderers():
            if cid in o.removed:
                continue
            sup = o.registrar.get_chain(cid)
            if sup is not None:
                out[o.oid] = sup.chain
        return out

    def supports(self, cid: str, voting_only: bool = True):
        out = {}
        for o in self.live_orderers():
            if voting_only and cid in o.removed:
                continue
            sup = o.registrar.get_chain(cid)
            if sup is not None:
                out[o.oid] = sup
        return out

    def leader_of(self, cid: str) -> Optional[str]:
        for oid, chain in self.chains(cid).items():
            if getattr(chain, "is_leader", False):
                return oid
        return None

    def pick_deliver_support(self, cid: str, at_least: int):
        """The failover source's selector: any live orderer, highest
        store first (a removed consenter's frozen store still serves
        history it has)."""
        best = None
        for o in self.live_orderers():
            sup = o.registrar.get_chain(cid)
            if sup is None:
                continue
            if best is None or sup.store.height > best.store.height:
                best = sup
        return best

    def pick_broadcast(self, cid: str) -> Broadcast:
        """Prefer the channel leader (no forward hop); else rotate
        through live orderers (the NOT_LEADER retry path)."""
        lead = self.leader_of(cid)
        with self._lock:
            if lead is not None and not self.orderers[lead].dead \
                    and not self.orderers[lead].partitioned:
                return self.orderers[lead].broadcast
            live = [o for o in self.orderers.values()
                    if not o.dead and not o.partitioned
                    and cid not in o.removed]
            self._rr += 1
            return live[self._rr % len(live)].broadcast

    def kill_orderer(self, oid: str) -> None:
        """SIGKILL analog: halt every chain, stop serving deliver."""
        with self._lock:
            o = self.orderers[oid]
            o.dead = True
        log.info("soak: killing orderer %s", oid)
        for cid in self.channel_ids:
            sup = o.registrar.get_chain(cid)
            if sup is not None:
                try:
                    sup.chain.halt()
                except Exception:
                    pass

    def restart_orderer(self, oid: Optional[str] = None,
                        hold_s: float = 0.0) -> str:
        """Crash-restart an orderer: halt its chains mid-traffic (the
        kill_orderer SIGKILL analog), retire the old Registrar object,
        and boot a FRESH one over the same ord/<oid> dirs — the WAL
        replay crops any torn tail, the HardState keeps term/vote,
        `_tip_raft_index` skips blocks already in the store, and
        AppendEntries repair refills whatever the halt lost.  Nothing
        the old incarnation ever ACKED may go missing: every ack sat
        behind a WAL sync barrier, so the replayed log carries it into
        the final exactly-once audit.  Prefers a live, fully-voting
        non-leader (quorum holds while it is down — the planner's
        precondition)."""
        if oid is None:
            lead = self.leader_of(self.channel_ids[0])
            with self._lock:
                cands = sorted(o.oid for o in self.orderers.values()
                               if not o.dead and not o.partitioned
                               and not o.removed)
            if not cands:
                raise RuntimeError("no live orderer to restart")
            oid = next((x for x in cands if x != lead), cands[0])
        self.kill_orderer(oid)
        with self._lock:
            self._retired_registrars.append(self.orderers[oid].registrar)
        if hold_s > 0:
            # the down window: traffic keeps flowing through the
            # surviving quorum while this member is gone
            time.sleep(hold_s)
        log.info("soak: restarting orderer %s from its WAL dir", oid)
        self._boot_orderer(oid)
        return oid

    # -- config events -----------------------------------------------------

    def _submit_update(self, cid: str, desired: m.ConfigGroup,
                       signers, attempts: int = 8) -> None:
        """Sign + submit a config update through the REAL broadcast
        path, retrying transient failures (leaderless windows,
        injected `orderer.raft.submit` faults from the background
        chaos plan)."""
        last: Optional[Exception] = None
        for _ in range(attempts):
            sup = None
            for o in self.live_orderers():
                if cid not in o.removed:
                    sup = o.registrar.get_chain(cid)
                    break
            if sup is None:
                raise RuntimeError(f"no live orderer for {cid}")
            cur = sup.bundle().config
            update = compute_update(cid, cur, desired)
            env = signed_update_envelope(cid, update, list(signers))
            try:
                self.pick_broadcast(cid).submit(env)
                return
            except Exception as e:         # noqa: BLE001
                last = e
                time.sleep(0.25)
        raise RuntimeError(
            f"config update on {cid} failed after retries: {last}")

    def _wait_sequence(self, cid: str, seq: int,
                       timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            sups = self.supports(cid)
            if sups and all(s.bundle().sequence >= seq
                            for s in sups.values()):
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"config sequence {seq} did not propagate on {cid}: "
            f"{[(o, s.bundle().sequence) for o, s in self.supports(cid).items()]}")

    def consenter_ids(self, cid: str) -> List[str]:
        sups = self.supports(cid)
        any_sup = next(iter(sups.values()))
        return list(any_sup.bundle().orderer.consenters())

    def _consenter_update(self, cid: str, new_ids: List[str]) -> None:
        sup = next(iter(self.supports(cid).values()))
        cur = sup.bundle().config
        want_seq = sup.bundle().sequence + 1
        desired = m.ConfigGroup.decode(cur.channel_group.encode())
        osec = groups_of(desired)[ORDERER]
        ctv = values_of(osec)[CONSENSUS_TYPE]
        ct = m.ConsensusType.decode(ctv.value)
        ct.metadata = m.RaftMetadata(consenters=list(new_ids)).encode()
        ctv.value = ct.encode()
        set_value(osec, CONSENSUS_TYPE, ctv)
        set_group(desired, ORDERER, osec)
        self._submit_update(cid, desired, [self.orderer_admin])
        self._wait_sequence(cid, want_seq)

    def add_consenter(self) -> str:
        """Admit a NEW consenter on every channel, then boot its
        replica from genesis — it catches up through the replicated
        log and becomes a voting member (reference: the raft
        reconfiguration + onboarding flow)."""
        with self._lock:
            new_id = f"o{len(self.orderers)}"
        for cid in self.channel_ids:
            self._consenter_update(
                cid, self.consenter_ids(cid) + [new_id])
        log.info("soak: consenter %s admitted; booting replica", new_id)
        self._boot_orderer(new_id)
        return new_id

    def remove_consenter(self) -> str:
        """Configure a consenter out on every channel — preferring a
        DEAD member (the operator repair after a kill), else a live
        follower (it stays up as a non-voting observer)."""
        ids0 = self.consenter_ids(self.channel_ids[0])
        with self._lock:
            dead = [oid for oid in ids0
                    if oid in self.orderers and self.orderers[oid].dead]
        lead = self.leader_of(self.channel_ids[0])
        candidates = dead or [oid for oid in ids0 if oid != lead]
        victim = candidates[0]
        for cid in self.channel_ids:
            keep = [oid for oid in self.consenter_ids(cid)
                    if oid != victim]
            self._consenter_update(cid, keep)
            with self._lock:
                if victim in self.orderers:
                    self.orderers[victim].removed.add(cid)
        log.info("soak: consenter %s configured out (dead=%s)",
                 victim, bool(dead))
        return victim

    def revoke_audit_org(self) -> int:
        """Remove the audit org from the application group of the
        event channel: its standing deliver subscription must be cut
        FORBIDDEN by the mid-stream session re-check.  Returns the
        peer-ledger height BEFORE the update (the revocation block
        lands at or after it)."""
        cid = self.channel_ids[0]
        pre_h = self.peers[0].height(cid)
        sup = next(iter(self.supports(cid).values()))
        want_seq = sup.bundle().sequence + 1
        desired = m.ConfigGroup.decode(
            sup.bundle().config.channel_group.encode())
        app = groups_of(desired)[APPLICATION]
        app.groups = [e for e in app.groups if e.key != AUDIT_ORG]
        set_group(desired, APPLICATION, app)
        # majority of the CURRENT app admins (audit org's own admin
        # not among the signers — it is being expelled)
        n_orgs = len(self.orgs) + 1
        signers = [self.admins[o]
                   for o in self.orgs[:n_orgs // 2 + 1]]
        self._submit_update(cid, desired, signers)
        self._wait_sequence(cid, want_seq)
        return pre_h

    def set_batch_size(self, cid: str) -> int:
        """Flip the channel's BatchSize.max_message_count (8 <-> 12):
        an orderer config update landing under load re-shapes block
        cutting while txs flow."""
        sup = next(iter(self.supports(cid).values()))
        want_seq = sup.bundle().sequence + 1
        new_count = 12 if self._batch_counts[cid] == 8 else 8
        desired = m.ConfigGroup.decode(
            sup.bundle().config.channel_group.encode())
        osec = groups_of(desired)[ORDERER]
        bsv = values_of(osec)[BATCH_SIZE]
        bs = m.BatchSize.decode(bsv.value)
        bs.max_message_count = new_count
        bsv.value = bs.encode()
        set_value(osec, BATCH_SIZE, bsv)
        set_group(desired, ORDERER, osec)
        self._submit_update(cid, desired, [self.orderer_admin])
        self._wait_sequence(cid, want_seq)
        self._batch_counts[cid] = new_count
        return new_count

    # -- peers -------------------------------------------------------------

    def add_peer(self, snapshot: bool = False) -> SoakPeer:
        """A peer joining mid-run: fresh ledgers from genesis, gossip
        join, catch-up via anti-entropy state transfer (the
        GossipStateProvider.anti_entropy_tick -> node._pull_range path
        at scale).  With `snapshot=True` the join takes the snapshot fast
        lane instead: the newcomer's ledger dirs are seeded from a
        snapshot of p0's state BEFORE the SoakPeer opens them, so it
        starts at the snapshot height and only gossips the tail —
        the convergence gate then proves its fingerprint matches the
        genesis-replay joiners' bit for bit."""
        org = self.orgs[self._peer_seq % len(self.orgs)]
        name = f"p{self._peer_seq}"
        self._peer_seq += 1
        if snapshot:
            self._seed_peer_from_snapshot(name)
        peer = SoakPeer(self, name, org)
        self.peers.append(peer)
        self._join_gossip(peer)
        peer.start()
        log.info("soak: peer %s joined (org %s, snapshot=%s)",
                 peer.name, org, snapshot)
        return peer

    def _join_gossip(self, peer: SoakPeer) -> None:
        for cid in self.channel_ids:
            eps = [p.nodes[cid].endpoint for p in self.peers]
            peer.nodes[cid].join(eps)
            # a couple of membership rounds so existing peers learn
            # the newcomer (and vice versa) promptly
            for _ in range(2):
                for p in self.peers:
                    p.nodes[cid].discovery.tick_send_alive()

    def _seed_peer_from_snapshot(self, name: str) -> Dict[str, int]:
        """Export p0's state per channel (consistent: under the commit
        lock) and bootstrap the newcomer's ledger dirs at the snapshot
        height.  Must run BEFORE SoakPeer construction — the bootstrap
        refuses dirs that already hold a ledger."""
        from fabric_mod_tpu_torch.ledger.snapshot import \
            bootstrap_from_snapshot
        heights: Dict[str, int] = {}
        for cid in self.channel_ids:
            src = self.peers[0].channels[cid].ledger
            snap = os.path.join(self.root, "snapshots", name, cid)
            meta = src.snapshot_to(snap)
            led = bootstrap_from_snapshot(
                snap, os.path.join(self.root, "peers", name, cid))
            heights[cid] = led.height
            led.close()                    # reopened by the SoakPeer
            log.info("soak: %s/%s snapshot-bootstrapped at height %d",
                     name, cid, meta["height"])
        return heights

    # -- crash/rejoin + partitions -----------------------------------------

    def crash_peer(self, name: Optional[str] = None) -> SoakPeer:
        """Hard-crash a non-anchor peer (p0 anchors the endorsers, the
        event server, and the audit subscription — never crashed).
        The victim leaves `self.peers`, its threads die, its durable
        dirs stay on disk, and the object itself is retained in
        `crashed_peers` (see SoakPeer.crash for why).  Survivors then
        expire its endpoints so membership — and any relay tree built
        over it — genuinely re-forms."""
        with self._lock:
            candidates = self.peers[1:]
            if not candidates:
                raise RuntimeError("no crashable peer (p0 is anchored)")
            victim = (next(p for p in candidates if p.name == name)
                      if name is not None else candidates[-1])
            self.peers.remove(victim)
            self.crashed_peers.append(victim)
        log.info("soak: hard-crashing peer %s", victim.name)
        victim.crash()
        self._drive_expiry(
            {cid: {victim.nodes[cid].endpoint}
             for cid in self.channel_ids})
        return victim

    def rejoin_peer(self, crashed: SoakPeer) -> SoakPeer:
        """Rejoin after a crash: a FRESH SoakPeer over the SAME
        durable dirs.  `KvLedger._recover` replays any
        statedb-behind-blockstore window (rebuilding the incremental
        XOR fingerprint through the same `_apply_state_updates`
        funnel) and gossip/relay converge the tail — the same join
        choreography as add_peer, minus the genesis bootstrap its
        nonzero heights skip."""
        peer = SoakPeer(self, crashed.name, crashed.org)
        self.peers.append(peer)
        self._join_gossip(peer)
        peer.start()
        log.info("soak: peer %s rejoined its ledger dirs (heights %s)",
                 peer.name,
                 {cid: peer.height(cid) for cid in self.channel_ids})
        return peer

    def install_partition(self):
        """The symmetric partition: the highest-numbered non-anchor
        peer plus one fully-voting non-leader orderer drop off every
        channel's gossip network AND raft transport.  Each side
        expires the other (the victim peer elects itself and converges
        alone; survivors re-form their trees); clients route around
        the partitioned orderer, whose raft messages black-hole until
        the heal.  Returns (peer_names, orderer_ids) for
        heal_partition."""
        with self._lock:
            peer_victims = ([self.peers[-1]]
                            if len(self.peers) > 1 else [])
        lead = self.leader_of(self.channel_ids[0])
        with self._lock:
            ord_cands = sorted(o.oid for o in self.orderers.values()
                               if not o.dead and not o.partitioned
                               and not o.removed and o.oid != lead)
            # quorum guard (the planner's precondition, re-checked at
            # runtime): cutting a voting orderer to the minority side
            # must leave a majority of the voting set connected, else
            # ordering halts for the whole hold
            voting = [o for o in self.orderers.values()
                      if not o.removed]
            connected = sum(1 for o in voting
                            if not o.dead and not o.partitioned)
            ord_victims = (ord_cands[:1]
                           if connected - 1 >= len(voting) // 2 + 1
                           else [])
            for oid in ord_victims:
                self.orderers[oid].partitioned = True
        for cid in self.channel_ids:
            for p in peer_victims:
                self.networks[cid].partitioned.add(
                    p.nodes[cid].endpoint)
            for oid in ord_victims:
                # raft traffic AND forwarded submits address the two
                # registered transport identities
                self.transports[cid].partitioned.add(oid)
                self.transports[cid].partitioned.add(f"{oid}:chain")
        log.info("soak: partition installed (peers=%s orderers=%s)",
                 [p.name for p in peer_victims], ord_victims)
        if peer_victims:
            self._drive_expiry(
                {cid: {p.nodes[cid].endpoint for p in peer_victims}
                 for cid in self.channel_ids})
        return [p.name for p in peer_victims], ord_victims

    def heal_partition(self, peer_names: List[str],
                       orderer_ids: List[str]) -> None:
        """Remove the cut: membership re-merges over a few alive
        rounds, the deliver election re-converges, the partitioned
        orderer's raft log is repaired by AppendEntries, and every
        relay tree re-deals via an explicit epoch bump."""
        for cid in self.channel_ids:
            for name in peer_names:
                p = next(q for q in self.peers if q.name == name)
                self.networks[cid].partitioned.discard(
                    p.nodes[cid].endpoint)
            for oid in orderer_ids:
                self.transports[cid].partitioned.discard(oid)
                self.transports[cid].partitioned.discard(f"{oid}:chain")
        with self._lock:
            for oid in orderer_ids:
                self.orderers[oid].partitioned = False
        for _ in range(3):
            for cid in self.channel_ids:
                for p in self.peers:
                    p.nodes[cid].discovery.tick_send_alive()
            time.sleep(0.05)
        self.bump_relay_epochs()
        log.info("soak: partition healed (peers=%s orderers=%s)",
                 peer_names, orderer_ids)

    def bump_relay_epochs(self) -> None:
        """Explicit tree rotation after a membership-shaped event
        (relay mode): every peer's next tree() re-parents even where
        its alive set ends up identical to the pre-event view."""
        for p in self.peers:
            for relay in p.relays.values():
                relay.bump_epoch()

    def _drive_expiry(self, targets: Dict[str, set],
                      timeout_s: float = 20.0) -> None:
        """Drive manual alive/expiry rounds (discovery is never
        background-ticked in the soak) under a temporarily tightened
        expiry until every endpoint in targets[cid] has dropped out of
        every OTHER live peer's membership view on cid.  Sends across
        a partition seam are dropped by the seam itself, so both sides
        of a cut expire each other in the same rounds."""
        deadline = time.monotonic() + timeout_s
        saved = {}
        for cid in targets:
            for p in self.peers:
                saved[(p.name, cid)] = p.nodes[cid].discovery.expiry_s
                p.nodes[cid].discovery.expiry_s = 0.6
        try:
            while time.monotonic() < deadline:
                gone = True
                for cid, eps in targets.items():
                    for p in self.peers:
                        d = p.nodes[cid].discovery
                        d.tick_send_alive()
                        d.tick_check_alive()
                        if p.nodes[cid].endpoint not in eps and \
                                eps & set(d.alive_endpoints()):
                            gone = False
                if gone:
                    return
                time.sleep(0.15)
        finally:
            for (pname, cid), v in saved.items():
                p = next((q for q in self.peers if q.name == pname),
                         None)
                if p is not None:
                    p.nodes[cid].discovery.expiry_s = v
        raise RuntimeError(
            f"endpoints never expired from live membership: {targets}")

    # -- dissemination relay (relay mode) ----------------------------------

    def gossip_leader(self, cid: str) -> Optional[str]:
        """The peer currently holding GOSSIP deliver leadership on a
        channel (distinct from the raft orderer leader)."""
        for p in self.peers:
            if p.services[cid].is_leader:
                return p.name
        return None

    def relay_stats(self) -> Dict[str, int]:
        """Aggregate BlockRelay counters across every peer/channel —
        the run-end proof that the tree actually carried blocks."""
        agg: Dict[str, int] = {}
        for p in self.peers:
            for relay in p.relays.values():
                for k, v in relay.stats.items():
                    agg[k] = agg.get(k, 0) + v
        return agg

    def partition_relay_leader(self, cid: str,
                               timeout_s: float = 20.0) -> str:
        """Cut the gossip relay ROOT off the channel's gossip network
        (the relay-mode churn amplifier riding leader_kill): survivors
        must expire it, elect a new root, and rebuild the tree.  The
        victim keeps its own DeliverClient and converges alone.
        Discovery is never background-ticked in the soak, so this
        drives the alive/expiry rounds itself under a temporarily
        tightened expiry.  Returns the victim peer's name."""
        victim = None
        deadline = time.monotonic() + timeout_s
        while victim is None:
            name = self.gossip_leader(cid)
            victim = next((p for p in self.peers if p.name == name),
                          None)
            if victim is None:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"no gossip leader to partition on {cid}")
                time.sleep(0.05)
        ep = victim.nodes[cid].endpoint
        self.networks[cid].partitioned.add(ep)
        log.info("soak: partitioned relay root %s (%s)", victim.name, ep)
        survivors = [p for p in self.peers if p is not victim]
        saved = {p.name: p.nodes[cid].discovery.expiry_s
                 for p in survivors}
        for p in survivors:
            p.nodes[cid].discovery.expiry_s = 0.6
        try:
            while time.monotonic() < deadline:
                gone = True
                for p in survivors:
                    d = p.nodes[cid].discovery
                    d.tick_send_alive()
                    d.tick_check_alive()
                    if ep in d.alive_endpoints():
                        gone = False
                if gone:
                    return victim.name
                time.sleep(0.15)
        finally:
            for p in survivors:
                p.nodes[cid].discovery.expiry_s = saved[p.name]
        raise RuntimeError(
            f"partitioned relay root {ep} never expired from the "
            f"survivors' membership views on {cid}")

    def heal_relay_leader(self, cid: str, peer_name: str) -> None:
        """Reconnect a partitioned relay root: membership re-forms
        over a few alive rounds and the election re-converges (another
        reparent — the returning minimum reclaims the root)."""
        peer = next(p for p in self.peers if p.name == peer_name)
        self.networks[cid].partitioned.discard(
            peer.nodes[cid].endpoint)
        for _ in range(3):
            for p in self.peers:
                p.nodes[cid].discovery.tick_send_alive()
            time.sleep(0.05)
        log.info("soak: healed relay root %s on %s", peer_name, cid)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._pump = RegisteredThread(target=self._pump_loop,
                                      name="soak-clock-pump",
                                      structure="SoakWorld")
        self._pump.start()
        for cid in self.channel_ids:
            for p in self.peers:
                p.nodes[cid].join(
                    [q.nodes[cid].endpoint for q in self.peers])
            for _ in range(2):
                for p in self.peers:
                    p.nodes[cid].discovery.tick_send_alive()
        for p in self.peers:
            p.start()
        # the audit org's standing subscription over the in-process
        # event service, gated by the REAL bundle-backed ACLProvider on
        # p0, its policy checks on the shared verifier
        cid0 = self.channel_ids[0]
        p0 = self.peers[0]
        acl = ACLProvider(p0.channels[cid0].bundle,
                          verify_many=p0.channels[cid0].verifier.verify_many)
        self.event_server = EventDeliverServer(
            cid0, p0.channels[cid0].ledger, acl)
        self.subscriber = _Subscriber(self.event_server, cid0,
                                      self.audit_client)

    def _pump_loop(self) -> None:
        while not self._pump_stop.is_set():
            self.clock.advance(self._clock_step)
            self._pump_stop.wait(self._clock_interval)

    def orderer_tip(self, cid: str) -> int:
        return max((s.store.height
                    for s in self.supports(cid).values()), default=0)

    def close(self) -> None:
        if self.subscriber is not None:
            self.subscriber.close()
        if self.event_server is not None:
            self.event_server.stop()
        for p in self.peers:
            p.stop()
        self._pump_stop.set()
        if self._pump is not None:
            assert_joined((self._pump,), owner="SoakWorld", timeout=5)
        with self._lock:
            regs = ([o.registrar for o in self.orderers.values()]
                    + list(self._retired_registrars))
        # crashed peers are deliberately NOT closed: their ledgers were
        # abandoned mid-flight and stay abandoned (the refs in
        # self.crashed_peers outlive the world so no finalizer flush
        # ever runs against a rejoined peer's files)
        for reg in regs:
            try:
                reg.close()
            except Exception:
                pass
