"""Channel participation: join, list and remove channels without a system
channel, onboarding from a later config block, and follower chains for
non-members.

The port's copy of fabric_mod_tpu/orderer/participation.py
(`FollowerChain` :38, `replicate_chain` :142, `ChannelParticipation`
:181; reference: orderer/common/channelparticipation/restapi.go:408 —
the operator API; orderer/common/onboarding/onboarding.go:447 — chain
replication when joining an existing channel; orderer/consensus/
follower/chain.go — the chain placeholder that keeps pulling blocks).

Trust model for onboarding, the reference's: the operator-supplied join
block is the anchor.  Replicated blocks are accepted only if they
hash-chain forward from genesis AND the block at the join height hashes
to exactly the join block.  In the port every replicated block after
genesis is also checked by the MCS against the BlockValidation policy
in force at its height (`ChainVerifier`), as the follower's pull and
Raft's catch-up check theirs; with a GpuVerifier that is one verify on
the card a block.  The reference's onboarding checks the chain and the
anchor only, so a source that alters nothing but an orderer signature
is refused here and taken there.

Not ported: the REST surface (`ChannelParticipation.handle`), which
rides the reference's operations HTTP server.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
from fabric_mod_tpu_torch.orderer.consensus import ChainHaltedError
from fabric_mod_tpu_torch.peer.mcs import (BlockVerificationError,
                                           MessageCryptoService)
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


class ParticipationError(Exception):
    pass


# status values (reference: channelparticipation's ChannelInfo)
ACTIVE, FOLLOWER = "active", "follower"


def is_config_block(block: m.Block) -> bool:
    try:
        envs = protoutil.get_envelopes(block)
        if len(envs) != 1:
            return False
        payload = protoutil.unmarshal_envelope_payload(envs[0])
        ch = m.ChannelHeader.decode(payload.header.channel_header)
        return ch.type == m.HeaderType.CONFIG
    except Exception:
        return False


class ChainVerifier:
    """Checks a channel's blocks in height order against the orderer
    BlockValidation policy in force at each height: the bundle starts at
    `bundle` (the config of the block before the first checked one) and
    follows every config block checked.  Block 0 (genesis, unsigned) is
    only ever anchored by the hash chain.  `verifier`: the batch verify
    seam (a GpuVerifier: one call on the card a block; None: the
    host)."""

    def __init__(self, channel_id: str, csp, verifier=None,
                 bundle: Optional[Bundle] = None):
        self.channel_id = channel_id
        self._csp = csp
        self._bundle = bundle
        self._mcs = MessageCryptoService(lambda: self._bundle, verifier)

    def check(self, block: m.Block) -> None:
        """Raises BlockVerificationError for a block the policy refuses;
        a config block then becomes the bundle for what follows."""
        if block.header.number > 0:
            if self._bundle is None:
                raise BlockVerificationError(
                    f"block {block.header.number}: no channel config to "
                    f"verify it against")
            self._mcs.verify_block(self.channel_id, block)
        if block.header.number == 0 or is_config_block(block):
            cid, config = config_from_block(block)
            if cid != self.channel_id:
                raise BlockVerificationError(
                    f"block {block.header.number} configures channel "
                    f"{cid!r}, not {self.channel_id!r}")
            self._bundle = Bundle(cid, config, self._csp)


class FollowerChain:
    """Consenter-shaped placeholder for a channel this orderer stores but
    does not order: it refuses Broadcast and keeps the ledger growing by
    pulling blocks (reference: follower/chain.go).  Every pulled block
    is checked by the MCS against the channel's current bundle with
    `verifier` (a GpuVerifier: on the card); a block the policy refuses
    stops the pull and is recorded in `rejected`.  A pulled block is
    stored as the source signed it (`ChainSupport.append_pulled`); the
    reference re-signs it with the follower's own identity through its
    block writer, so its follower's chain differs from the source's in
    the signature metadata.  A verifier error is
    not a refusal: it ends the pull loop and is kept in `errors` (no
    fallback).  `is_member` / `on_member` are the promotion seam, as in
    the reference."""

    POLL_INTERVAL_S = 0.2

    def __init__(self, support, block_fetcher, verifier=None,
                 is_member: Optional[Callable[[], bool]] = None,
                 on_member: Optional[Callable[[], None]] = None):
        self._support = support
        self._fetch = block_fetcher
        self._mcs = MessageCryptoService(support.bundle, verifier)
        self._is_member = is_member
        self._on_member = on_member
        self.rejected: List[int] = []
        self.errors: List[BaseException] = []
        self._halted = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="participation", daemon=True)

    # -- consenter surface (order/configure refuse) ----------------------
    def start(self) -> None:
        self._thread.start()

    def halt(self) -> None:
        self._halted.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def wait_ready(self) -> None:
        raise ChainHaltedError("this orderer is a follower of the "
                               "channel; it does not accept Broadcast")

    def order(self, env, config_seq) -> None:
        self.wait_ready()

    def configure(self, env, config_seq) -> None:
        self.wait_ready()

    # -- the pull loop -----------------------------------------------------
    def poll_once(self) -> int:
        """One catch-up attempt; returns the blocks appended (reference
        :83).  The fetch source is untrusted: each block must extend the
        chain and pass the MCS (reference :105, cluster.VerifyBlocks)."""
        if self._fetch is None:
            return 0
        store = self._support.store
        try:
            blocks = self._fetch(store.height, 0)   # 0: to the source's tip
        except Exception:
            return 0                       # source unreachable: retry later
        appended = 0
        for block in blocks or []:
            if block.header.number != store.height:
                break
            if store.height and \
                    block.header.previous_hash != store.last_block_hash:
                self._reject(block.header.number)
                break                      # broken chain: stop pulling
            try:
                self._mcs.verify_block(self._support.channel_id, block)
            except BlockVerificationError:
                self._reject(block.header.number)
                break                      # refused: stop pulling
            self._support.append_pulled(block, is_config_block(block))
            appended += 1
        if appended and self._is_member is not None and self._is_member():
            if self._on_member is not None:
                cb, self._on_member = self._on_member, None
                cb()
        return appended

    def _reject(self, num: int) -> None:
        """Record a refused height once, however often it is re-pulled."""
        if not self.rejected or self.rejected[-1] != num:
            self.rejected.append(num)

    def _run(self) -> None:
        try:
            while not self._halted.is_set():
                self.poll_once()
                self._halted.wait(self.POLL_INTERVAL_S)
        except Exception as e:             # kept for the owner; ends here
            self.errors.append(e)


def replicate_chain(store, join_block: m.Block, block_fetcher,
                    verify: Optional[Callable[[m.Block], None]] = None
                    ) -> None:
    """Onboard: pull blocks [height, join height], check the WHOLE chain
    against the join-block anchor, then append (reference :142,
    onboarding.go:447 + cluster replication.go:677).  Nothing is written
    until every check passes: a lying source must not leave a poisoned
    partial chain behind.  `verify(block)`, in height order, is the
    port's signature check (ChainVerifier.check).  Raises
    ParticipationError when the source lies."""
    target = join_block.header.number
    if block_fetcher is None:
        raise ParticipationError(
            "joining at height %d needs a block fetcher" % target)
    start = store.height
    blocks: List[m.Block] = []
    while start + len(blocks) <= target:
        batch = block_fetcher(start + len(blocks), target + 1)
        if not batch:
            raise ParticipationError(
                "replication source has no blocks %d..%d"
                % (start + len(blocks), target))
        for block in batch:
            if block.header.number != start + len(blocks):
                raise ParticipationError("replicated block out of order")
            blocks.append(block)
            if block.header.number == target:
                break
    # check before writing: hash-chain continuity, then the anchor
    prev = store.last_block_hash if start else None
    for block in blocks:
        if prev is not None and block.header.previous_hash != prev:
            raise ParticipationError(
                "replicated block %d breaks the hash chain"
                % block.header.number)
        prev = protoutil.block_header_hash(block.header)
    if prev != protoutil.block_header_hash(join_block.header):
        raise ParticipationError(
            "replicated chain does not end at the join block "
            "(forged history)")
    if verify is not None:
        for block in blocks:
            try:
                verify(block)
            except BlockVerificationError as e:
                raise ParticipationError(
                    f"replicated block {block.header.number} refused: "
                    f"{e}") from e
    for block in blocks:
        store.add_block(block)


def store_fetcher(store):
    """A block fetcher over another orderer's block store: `fetch(lo,
    hi)` returns its blocks [lo, hi) (hi 0: to its tip), as the
    in-process stand-in for the reference's cluster block puller."""
    def fetch(lo: int, hi: int) -> List[m.Block]:
        top = store.height if hi == 0 else min(hi, store.height)
        return [store.get_block_by_number(i) for i in range(lo, top)]
    return fetch


class ChannelParticipation:
    """The operator surface (reference :181, restapi.go:408) over a
    Registrar: list, inspect, join and remove channels."""

    def __init__(self, registrar, block_fetcher=None):
        self._registrar = registrar
        self._fetcher = block_fetcher

    def list_channels(self) -> List[Dict]:
        return [self.channel_info(cid)
                for cid in self._registrar.channel_ids()]

    def channel_info(self, channel_id: str) -> Dict:
        support = self._registrar.get_chain(channel_id)
        if support is None:
            raise ParticipationError(f"unknown channel {channel_id!r}")
        chain = support.chain
        status = FOLLOWER if isinstance(chain, FollowerChain) else ACTIVE
        info = {"name": channel_id, "height": support.store.height,
                "status": status}
        # consensus leadership where the consenter knows it (Raft)
        if hasattr(chain, "is_leader"):
            info["is_leader"] = bool(chain.is_leader)
            if hasattr(chain, "leader_id"):
                info["leader_id"] = chain.leader_id
        return info

    def join(self, join_block: m.Block, as_follower: bool = False):
        """Join from a genesis block (height 0) or onboard from a later
        config block by replicating the chain first."""
        cid, _config = config_from_block(join_block)
        if self._registrar.get_chain(cid) is not None:
            raise ParticipationError(f"channel {cid!r} exists")
        if as_follower and self._fetcher is None and \
                self._registrar.block_fetcher is None:
            # a fetcher-less follower would sit at the join height
            # forever with no error anywhere
            raise ParticipationError(
                "this node has no replication source configured; "
                "follower channels cannot pull blocks")
        return self._registrar.join_channel(
            join_block, block_fetcher=self._fetcher,
            as_follower=as_follower)

    def remove(self, channel_id: str) -> None:
        self._registrar.remove_channel(channel_id)
