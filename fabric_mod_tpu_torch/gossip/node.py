"""The gossip node: push dissemination + pull anti-entropy + routing.

The port's copy of fabric_mod_tpu/gossip/node.py `GossipNode`
(reference: gossip/gossip/gossip_impl.go — handleMessage routing, the
sqrt-N push fan-out, the message store's dedup — and algo/pull.go's
hello/digest/request/update engine).

One node per (peer, channel).  A block is MCS-verified (the orderer
signature policy over the channel's batch verifier) BEFORE it enters
the state buffer — the gate the deliver client applies
(internal/peer/gossip/mcs.go:124).  Every inbound envelope's signature
is checked by the identity mapper through the same verifier.

A message that does not decode, an envelope whose signature fails, an
identity the MSP rejects and a block the MCS rejects are dropped, as
in the reference; what else a check raises (the verifier's own errors)
propagates to the sender's thread (gossip/comm.py).  `on_relay` is the
dissemination layer's receive hook: `RelayService.start` sets it to its
`BlockRelay.on_relay`; without a relay, relay messages are dropped.

Private data (reference :192-355; gossip/privdata's distributor.go:458,
reconcile.go:339, pull.go:727): `distribute_pvt` sends a private write
set only to alive peers its mandatory `eligible` filter admits (the
collection's member-orgs policy, `eligibility_by_policy`: fail-closed);
a received one goes to the channel's transient store, where the commit
checks it against the block's hashes.  `reconcile_tick` asks a few
peers for the digests the ledger committed without plaintext; a
responder serves only a requester whose identity satisfies the
collection's policy, and the ledger re-checks every returned write set
against the committed hashes, so a forged response is rejected there.
The reference's backlog gauge is left out: `ledger.missing_pvt_count()`
reads the backlog.
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional

from fabric_mod_tpu_torch.gossip.comm import GossipComm, InProcNetwork
from fabric_mod_tpu_torch.gossip.discovery import Discovery
from fabric_mod_tpu_torch.gossip.identity import (
    IDENTITY_REJECTED, IdentityMapper, pki_id_of)
from fabric_mod_tpu_torch.gossip.msgstore import TTLMessageStore
from fabric_mod_tpu_torch.gossip.protoext import sign_message, verify_envelope
from fabric_mod_tpu_torch.gossip.state import GossipStateProvider
from fabric_mod_tpu_torch.peer.mcs import BlockVerificationError
from fabric_mod_tpu_torch.policy.manager import compile_policy_bytes
from fabric_mod_tpu_torch.protos import messages as m


class GossipNode:
    """`rng` picks the push and pull targets and the nonces; `clock` is
    the membership view's liveness clock (Discovery's; wall time unless
    given).  The reference's `fanout` override of the sqrt-N push width
    is not ported: nothing sets it."""

    # hello answers carry at most this many trailing block digests: the
    # standing pull cadence stays O(window), not O(height); a far-behind
    # puller still converges window by window
    PULL_DIGEST_WINDOW = 64

    def __init__(self, endpoint: str, signer, channel,
                 network: InProcNetwork,
                 rng: Optional[random.Random] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.endpoint = endpoint
        self._signer = signer
        self._channel = channel          # peer.Channel (MCS + commit)
        self._network = network
        self._rng = rng or random.Random()
        self._identity = signer.serialize()
        self.pki_id = pki_id_of(self._identity)
        self.mapper = IdentityMapper(channel.bundle().msp_manager,
                                     channel.verifier)
        self.mapper.put(self._identity)
        self.comm = GossipComm(endpoint, self.pki_id, network, signer)
        self._members_by_pki: Dict[bytes, str] = {}
        self.discovery = Discovery(
            m.GossipMember(endpoint=endpoint, pki_id=self.pki_id),
            self._identity, self.comm, clock=clock)
        self.state = GossipStateProvider(
            channel, request_missing=self._pull_range,
            on_tick=self.pull_tick)
        # TTL'd duplicate suppression (reference: gossip msgstore)
        self._seen = TTLMessageStore(ttl_s=120.0)
        # the dissemination layer's receive hook (RelayService.start);
        # relay messages are dropped while it is None
        self.on_relay: Optional[Callable[[m.GossipMessage], None]] = None
        network.register(endpoint, self.on_message)

    # -- outbound ---------------------------------------------------------
    def _pick_peers(self, k: Optional[int] = None) -> List[str]:
        peers = [p for p in self.discovery.alive_endpoints()
                 if p != self.endpoint]
        if not peers:
            return []
        if k is None:
            # sqrt-N fan-out with the reference's small-net floor
            k = max(2, int(math.isqrt(len(peers))))
        self._rng.shuffle(peers)
        return peers[:k]

    def gossip_block(self, block: m.Block) -> None:
        """Push a block to ~sqrt(N) peers (reference: the emit/fan-out
        path of gossip_impl.go)."""
        nonce = self._rng.getrandbits(63)
        msg = m.GossipMessage(
            nonce=nonce, channel=self._channel.channel_id.encode(),
            data_msg=m.DataMessage(payload=m.GossipPayload(
                seq_num=block.header.number, data=block.encode())))
        self._remember_nonce(nonce)
        self.comm.broadcast(self._pick_peers(), msg)

    def _remember_nonce(self, nonce: int) -> bool:
        """Record a nonce; False when already seen within the TTL."""
        return self._seen.check_and_add(nonce)

    def join(self, bootstrap_endpoints: List[str]) -> None:
        """Announce ourselves to bootstrap peers."""
        msg = self.discovery.make_alive()
        self.comm.broadcast(
            [e for e in bootstrap_endpoints if e != self.endpoint], msg)

    # -- inbound routing (reference: gossip_impl.go handleMessage) -------
    def on_message(self, src_pki_id: bytes, env_bytes: bytes) -> None:
        try:
            env = m.GossipEnvelope.decode(env_bytes)
        except ValueError:
            return
        msg = verify_envelope(
            env, lambda payload, sig:
            self.mapper.verify(src_pki_id, payload, sig)
            or self._verify_with_carried_identity(env, payload, sig))
        if msg is None:
            return
        if msg.alive_msg is not None:
            self._handle_alive(src_pki_id, msg.alive_msg)
        elif msg.data_msg is not None:
            self._handle_data(msg)
        elif msg.hello is not None:
            self._handle_hello(src_pki_id, msg)
        elif msg.data_dig is not None:
            self._handle_digest(src_pki_id, msg)
        elif msg.data_req is not None:
            self._handle_request(src_pki_id, msg)
        elif msg.data_update is not None:
            self._handle_update(msg)
        elif msg.private_data is not None:
            self._handle_private(msg)
        elif msg.pvt_req is not None:
            self._handle_pvt_request(src_pki_id, msg)
        elif msg.pvt_resp is not None:
            self._handle_pvt_response(msg)
        elif msg.relay_msg is not None:
            handler = self.on_relay
            if handler is not None:
                handler(msg)

    def _verify_with_carried_identity(self, env, payload, sig) -> bool:
        """Bootstrap: an alive message carries its own identity — admit
        it if the MSP validates it and the signature checks (reference:
        the identity learning on first contact)."""
        try:
            msg = m.GossipMessage.decode(env.payload)
        except ValueError:
            return False
        if msg.alive_msg is None or not msg.alive_msg.identity:
            return False
        try:
            pid = self.mapper.put(msg.alive_msg.identity)
        except IDENTITY_REJECTED:
            return False
        return self.mapper.verify(pid, payload, sig)

    def _handle_alive(self, src: bytes, alive: m.AliveMessage) -> None:
        pid = (pki_id_of(alive.identity) if alive.identity
               else (alive.membership.pki_id if alive.membership else b""))
        if not pid or pid == self.pki_id:
            return
        if alive.membership is not None:
            self._members_by_pki[pid] = alive.membership.endpoint
        if self.discovery.handle_alive(pid, alive):
            # fresh news travels (push membership epidemically)
            fwd = m.GossipMessage(alive_msg=alive)
            self.comm.broadcast(
                [e for e in self._pick_peers()
                 if e != (alive.membership.endpoint
                          if alive.membership else "")], fwd)

    def _verified_block(self, payload: Optional[m.GossipPayload]
                        ) -> Optional[m.Block]:
        """The payload's block if it decodes and passes the MCS, else
        None (dropped, never relayed)."""
        if payload is None:
            return None
        try:
            block = m.Block.decode(payload.data)
        except ValueError:
            return None
        try:
            self._channel.mcs.verify_block(self._channel.channel_id, block)
        except BlockVerificationError:
            return None
        return block

    def _handle_data(self, msg: m.GossipMessage) -> None:
        if not self._remember_nonce(msg.nonce):
            return                          # dedup (message store)
        block = self._verified_block(msg.data_msg.payload)
        if block is None:
            return
        if self.state.add_block(block):
            # forward fresh blocks (push epidemic)
            self.comm.broadcast(self._pick_peers(), msg)

    # -- private data distribution (reference: gossip/privdata/
    # -- distributor.go:458 — plaintext to ELIGIBLE peers only) ----------
    def distribute_pvt(self, txid: str, pvt_rwset,
                       eligible: Callable[[bytes], bool]) -> int:
        """Send a private write set to the alive peers whose identity
        `eligible` admits; the filter is mandatory (fail-closed).
        Returns the peers reached."""
        msg = m.GossipMessage(
            nonce=self._rng.getrandbits(63),
            channel=self._channel.channel_id.encode(),
            private_data=m.PvtDataElement(
                txid=txid, payload=pvt_rwset.encode()))
        sent = 0
        for member in self.discovery.alive_members():
            if member.endpoint == self.endpoint:
                continue
            ident = self.mapper.get(member.pki_id)
            if ident is None or not eligible(ident):
                continue
            if self.comm.send(member.endpoint, msg):
                sent += 1
        return sent

    def _handle_private(self, msg: m.GossipMessage) -> None:
        """A received write set goes to the transient store, channel
        checked; the commit checks it against the block's hashes, and
        the store bounds its growth."""
        pd = msg.private_data
        if not pd.txid or not pd.payload:
            return
        if msg.channel != self._channel.channel_id.encode():
            return                          # cross-channel leak guard
        try:
            pvt = m.TxPvtReadWriteSet.decode(pd.payload)
        except ValueError:
            return
        self._channel.transient_store.persist(
            pd.txid, self._channel.ledger.height, pvt)

    def eligibility_by_policy(self, member_orgs_policy):
        """eligible(identity_bytes) for a collection's
        member_orgs_policy (a SignaturePolicyEnvelope): the identity
        must deserialize, validate in full (a revoked peer stops
        receiving plaintext) and satisfy the policy's principals."""
        bundle = self._channel.bundle()
        msp_mgr = bundle.msp_manager
        pol = compile_policy_bytes(member_orgs_policy.encode(), msp_mgr,
                                   bundle.sequence)

        def eligible(identity_bytes: bytes) -> bool:
            try:
                ident = msp_mgr.deserialize_identity(identity_bytes)
                msp_mgr.validate(ident)
            except IDENTITY_REJECTED:
                return False
            return pol.satisfied_by_principals([ident])
        return eligible

    # -- private data reconciliation (reference: gossip/privdata/
    # -- reconcile.go:339 + pull.go:727) ---------------------------------
    def reconcile_tick(self) -> int:
        """Ask up to 3 random alive peers for the private write sets
        this peer committed hashes of without the plaintext.  Returns
        the number of digests requested."""
        missing = self._channel.ledger.missing_pvt()
        if not missing:
            return 0
        digests = [m.PvtDataDigest(block_num=bn, tx_num=tn,
                                   namespace=ns, collection=coll)
                   for bn, tn, ns, coll in missing]
        req = m.GossipMessage(
            nonce=self._rng.getrandbits(63),
            channel=self._channel.channel_id.encode(),
            pvt_req=m.PvtDataRequest(nonce=self._rng.getrandbits(63),
                                     digests=digests))
        peers = self._pick_peers(3)
        if not peers:
            return 0
        self.comm.broadcast(peers, req)
        return len(digests)

    def _handle_pvt_request(self, src: bytes, msg: m.GossipMessage) -> None:
        """Serve a missing-data request ONLY to a requester whose
        identity satisfies the collection's member_orgs_policy: an
        ineligible peer learns nothing, not even whether the data
        exists."""
        if msg.channel != self._channel.channel_id.encode():
            return
        src_ep = self._members_by_pki.get(src)
        ident = self.mapper.get(src)
        if src_ep is None or ident is None:
            return
        ledger = self._channel.ledger
        eligible_cache: Dict = {}
        elements = []
        for dig in msg.pvt_req.digests:
            key = (dig.namespace, dig.collection)
            if key not in eligible_cache:
                pol = self._channel.collection_policy(*key)
                eligible_cache[key] = (
                    (lambda _b: False) if pol is None
                    else self.eligibility_by_policy(pol))
            if not eligible_cache[key](ident):
                continue
            for ns, coll, kv in ledger.get_pvt(dig.block_num, dig.tx_num):
                if ns == dig.namespace and coll == dig.collection:
                    elements.append(m.PvtDataResponseElement(
                        digest=dig, rwset=kv.encode()))
        if not elements:
            return
        self.comm.send(src_ep, m.GossipMessage(
            nonce=self._rng.getrandbits(63),
            channel=self._channel.channel_id.encode(),
            pvt_resp=m.PvtDataResponse(nonce=msg.pvt_req.nonce,
                                       elements=elements)))

    def _handle_pvt_response(self, msg: m.GossipMessage) -> None:
        """Backfill the returned write sets; the ledger re-checks each
        against the committed block's hashes."""
        if msg.channel != self._channel.channel_id.encode():
            return
        ledger = self._channel.ledger
        for el in msg.pvt_resp.elements:
            if el.digest is None or not el.rwset:
                continue
            try:
                kv = m.KVRWSet.decode(el.rwset)
            except ValueError:
                continue
            ledger.reconcile_pvt(el.digest.block_num, el.digest.tx_num,
                                 el.digest.namespace,
                                 el.digest.collection, kv)

    # -- pull engine (reference: algo/pull.go) ----------------------------
    def pull_tick(self) -> None:
        """Send a hello to one random peer asking what blocks it has."""
        peers = self._pick_peers(1)
        if not peers:
            return
        nonce = self._rng.getrandbits(63)
        self.comm.send(peers[0], m.GossipMessage(
            nonce=nonce, hello=m.GossipHello(nonce=nonce)))

    def _pull_range(self, gap: range) -> None:
        peers = self._pick_peers(1)
        if not peers:
            return
        digests = [str(n).encode() for n in gap]
        self.comm.send(peers[0], m.GossipMessage(
            data_req=m.DataRequest(nonce=self._rng.getrandbits(63),
                                   digests=digests)))

    def _handle_hello(self, src: bytes, msg: m.GossipMessage) -> None:
        src_ep = self._members_by_pki.get(src)
        if src_ep is None:
            return
        height = self._channel.ledger.height
        lo = max(0, height - self.PULL_DIGEST_WINDOW)
        digests = [str(n).encode() for n in range(lo, height)]
        self.comm.send(src_ep, m.GossipMessage(
            data_dig=m.DataDigest(nonce=msg.hello.nonce,
                                  digests=digests)))

    def _handle_digest(self, src: bytes, msg: m.GossipMessage) -> None:
        src_ep = self._members_by_pki.get(src)
        if src_ep is None:
            return
        have = self._channel.ledger.height
        wanted = []
        for d in msg.data_dig.digests:      # peer-supplied: parse safely
            try:
                if int(d.decode()) >= have:
                    wanted.append(d)
            except ValueError:
                continue
        if not wanted:
            return
        self.comm.send(src_ep, m.GossipMessage(
            data_req=m.DataRequest(nonce=msg.data_dig.nonce,
                                   digests=wanted)))

    def _handle_request(self, src: bytes, msg: m.GossipMessage) -> None:
        src_ep = self._members_by_pki.get(src)
        if src_ep is None:
            return
        out = []
        for d in msg.data_req.digests:
            try:
                num = int(d.decode())
            except ValueError:
                continue
            block = self._channel.ledger.get_block_by_number(num)
            if block is None:
                continue
            inner = m.GossipMessage(
                nonce=self._rng.getrandbits(63),
                data_msg=m.DataMessage(payload=m.GossipPayload(
                    seq_num=num, data=block.encode())))
            out.append(sign_message(inner, self._signer))
        if out:
            self.comm.send(src_ep, m.GossipMessage(
                data_update=m.DataUpdate(nonce=msg.data_req.nonce,
                                         data=out)))

    def _handle_update(self, msg: m.GossipMessage) -> None:
        for env in msg.data_update.data:
            inner = verify_envelope(
                env, lambda payload, sig: True)  # block sigs checked next
            if inner is None or inner.data_msg is None:
                continue
            block = self._verified_block(inner.data_msg.payload)
            if block is not None:
                self.state.add_block(block)

    def stop(self) -> None:
        self._network.unregister(self.endpoint)
        self.discovery.stop()
        self.state.stop()
