"""RelayService: the dissemination layer's binding to leadership.

The port's copy of fabric_mod_tpu/dissemination/service.py, composed
into GossipService's election transitions (gossip/service.py,
`GossipService(node, ..., relay=RelayService(node))`):

  elected leader  -> the sole DeliverClient; each committed block's
                     frame comes off this service's BlockFanout ring and
                     is pushed down the tree (`on_leader_commit`)
  demotion        -> the relay root tears down (queued frames dropped;
                     whatever the children miss, anti-entropy repairs)
  promotion       -> rebuilt from the channel's current height (a
                     returning leader relays new commits only; history
                     is anti-entropy's job, as the DeliverClient resumes
                     from the committed height)

Non-leaders never see the write side: relayed blocks enter through
`BlockRelay.on_relay` -> MCS verify -> `GossipStateProvider.add_block`,
the in-order buffer and commit path every gossiped block rides.  The
reference's knobs are constructor arguments with its defaults:
`degree` (FABRIC_MOD_TPU_RELAY_DEGREE, 4), `queue_cap`
(FABRIC_MOD_TPU_RELAY_QUEUE, 64) and `ring_size`
(FABRIC_MOD_TPU_FANOUT_RING, 128).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.dissemination.relay import QUEUE_CAP, BlockRelay
from fabric_mod_tpu_torch.dissemination.tree import DEGREE, RelayTree
from fabric_mod_tpu_torch.peer.fanout import RING_SIZE, BlockFanout, encode_frame
from fabric_mod_tpu_torch.protos import messages as m


class RelayService:
    """One channel's relay composition over a GossipNode."""

    def __init__(self, node, degree: int = DEGREE,
                 queue_cap: int = QUEUE_CAP, ring_size: int = RING_SIZE,
                 leader_source: Optional[Callable[[], str]] = None,
                 epoch: int = 0):
        """`leader_source`: () -> the leader endpoint the tree roots at;
        the default mirrors the deterministic election (min PKI-ID over
        {self} and the alive members), so every peer with a converged
        view derives the root the election elects."""
        self._node = node
        channel = node._channel
        self._cid = channel.channel_id
        # the leader's frame source: the bounded ring the deliver
        # fan-out runs on, one materialize and one encode per block
        self._ring = BlockFanout(self._cid, channel.ledger, "full",
                                 ring_size)
        self._degree = degree
        self._epoch = int(epoch)
        self._leader_source = leader_source or self._elected_leader
        self.relay = BlockRelay(node, self.tree, queue_cap=queue_cap)
        self._lock = RegisteredLock("dissemination.service._lock")
        self._is_root = False
        self._root_from = 0
        # the membership the current epoch was minted for: any change (a
        # join, a crash expiry, a healed partition) advances the epoch,
        # so the next tree() re-deals interior positions
        self._epoch_members: Optional[frozenset] = None

    # -- tree derivation --------------------------------------------------
    def _elected_leader(self) -> str:
        """The deterministic mirror of LeaderElectionService: min PKI-ID
        over {self} and the alive members, mapped to its endpoint."""
        cands = [(self._node.pki_id, self._node.endpoint)]
        for mb in self._node.discovery.alive_members():
            cands.append((mb.pki_id, mb.endpoint))
        return min(cands)[1]

    def tree(self) -> RelayTree:
        members = [self._node.endpoint] + \
            [mb.endpoint for mb in self._node.discovery.alive_members()]
        self._note_membership(members)
        return RelayTree(members, self._leader_source(),
                         epoch=self._epoch, degree=self._degree)

    def _note_membership(self, members) -> None:
        """Advance the epoch when the alive set changes."""
        key = frozenset(members)
        with self._lock:
            if self._epoch_members is None:
                self._epoch_members = key
            elif key != self._epoch_members:
                self._epoch_members = key
                self._epoch += 1

    def bump_epoch(self) -> int:
        """Explicit rotation: the next tree() re-parents even with an
        unchanged member set."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._node.on_relay = self.relay.on_relay
        self.relay.start()

    def stop(self) -> None:
        self.relay.stop()
        if self._node.on_relay == self.relay.on_relay:
            self._node.on_relay = None

    # -- leadership transitions (driven by GossipService) -----------------
    def on_leadership(self, is_leader: bool) -> None:
        with self._lock:
            was, self._is_root = self._is_root, bool(is_leader)
        if is_leader and not was:
            self.promote()
        elif was and not is_leader:
            self.demote()

    def promote(self) -> None:
        """Rebuild the relay root from the channel's current height:
        anything a peer misses below it is a gap its anti-entropy pulls."""
        self._root_from = self._node._channel.ledger.height
        self.relay.clear()

    def demote(self) -> None:
        self.relay.clear()

    # -- the leader's commit hook (DeliverClient on_commit) ---------------
    def on_leader_commit(self, block: m.Block) -> None:
        """Frame the committed block off the fan-out ring and push it
        down the tree (in place of the leader's epidemic gossip_block:
        every peer is a tree member, loss repair is anti-entropy's)."""
        with self._lock:
            if not self._is_root:
                return                     # demoted mid-callback
        num = block.header.number
        fr = self._ring.get(num)
        if fr is not None:
            self.relay.push_frame(fr.num, fr.payload, fr.is_config)
            return
        # the commit signalled but the ledger read raced it (the commit
        # pipe's edge): encode the block in hand, the same bytes
        self.relay.push_frame(num, encode_frame(self._cid, "full", block))

    # -- introspection ----------------------------------------------------
    @property
    def stats(self) -> Dict[str, int]:
        return self.relay.stats

    @property
    def ring_stats(self) -> Dict[str, int]:
        return self._ring.stats

    @property
    def errors(self):
        return self.relay.errors
