"""The Raft-backed consenter: the consenter contract over RaftNode.

The port's copy of fabric_mod_tpu/orderer/raftchain.py `RaftChain`
(:62; reference: orderer/consensus/etcdraft/chain.go — Order/Configure
at :381/:387, Submit forwarding to the leader at :494, the leader's
block cutter and batch timer inside run at :533, block writing on apply
at :791/:964).

The replicated payload is one cut batch (a kind byte, then BlockData of
envelope bytes).  Every node builds the block at apply time from its own
chain tip: heights, previous hashes and data hashes are the same on
every node because the apply order is, and only the per-node metadata
signature differs.  The raft index of the entry rides in block metadata
slot 3, so a node restarted over its WAL skips the entries already in
its store.  A config batch carries one envelope and swaps the bundle
through the same ChainSupport.process_config path as the solo
consenter.

A follower forwards each submit to the leader over the transport
(`<id>:chain` endpoints); a submit that finds no route (an election in
flight) or a full queue after it was accepted is parked, never dropped
below the parked bound.  `submit_queue_cap` > 0 (the admission
setting, orderer/admission.py) bounds the submit queue with NON-blocking
puts: a full queue sheds a normal tx with the typed
ResourceExhaustedError, while config and priority envelopes wait for
room (reference :109-227); 0 keeps the blocking 10,000-entry queue.
Dropped submits are counted in `dropped` and in the admission module's
chain drop counter (reference :312-385).  The reference's
`orderer.raft.submit` fault point sits in the leaderless-submit check.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.orderer import admission
from fabric_mod_tpu_torch.orderer.consensus import (SUBMIT_QUEUE_CAP,
                                                    ChainHaltedError,
                                                    NotLeaderError)
from fabric_mod_tpu_torch.orderer.raft import LEADER, RaftNode, RaftTransport
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

_NORMAL, _CONFIG = 0, 1


class _Submit:
    """An envelope forwarded to the leader (reference: Submit :494)."""

    __slots__ = ("env_bytes", "is_config", "config_seq")

    def __init__(self, env_bytes: bytes, is_config: bool,
                 config_seq: int):
        self.env_bytes = env_bytes
        self.is_config = is_config
        self.config_seq = config_seq


def _encode_batch(envs: List[m.Envelope], kind: int) -> bytes:
    return bytes([kind]) + m.BlockData(
        data=[e.encode() for e in envs]).encode()


def _decode_batch(data: bytes) -> Tuple[int, List[m.Envelope]]:
    kind = data[0]
    bd = m.BlockData.decode(data[1:])
    return kind, [m.Envelope.decode(d) for d in bd.data]


class RaftChain:
    """A consenter with the SoloChain surface (order, configure, start,
    halt, wait_ready) and leader awareness.

    `election_timeout`, `heartbeat_s`, `clock`, `rng`, `pipeline`,
    `queue_cap` and `group_commit` pass through to RaftNode (the
    defaults are the reference's).  `snapshot_interval` compacts the raft
    log every N applied entries (reference: SnapshotIntervalSize).
    `block_fetcher(from_height, to_height) -> [Block]` lets a lagging
    node pull the blocks it can no longer rebuild from compacted entries
    (reference: the cluster block puller, cluster/deliver.go:571); it
    runs on the FSM thread, so it must bound its own time.  The batch
    timer runs on wall time even under a manual clock (cutting a partial
    batch late is benign; a spurious election is not).
    `submit_queue_cap` > 0 bounds the submit queue with non-blocking
    puts (admission)."""

    RAFT_INDEX_MD_SLOT = 3                 # block metadata slot
    _PARKED_CAP = SUBMIT_QUEUE_CAP         # mirrors the ingress queue

    def __init__(self, node_id: str, peer_ids: List[str],
                 transport: RaftTransport, wal_path: str, support,
                 election_timeout=(0.15, 0.3), heartbeat_s=0.05,
                 snapshot_interval: Optional[int] = None,
                 block_fetcher=None, clock=None, rng=None,
                 pipeline: int = 0, queue_cap: int = 8192,
                 group_commit: bool = False, submit_queue_cap: int = 0):
        self.node_id = node_id
        self._support = support
        self._transport = transport
        self._fetch_blocks = block_fetcher
        self._pipeline = max(0, int(pipeline))
        # the channel config's consenter set is authoritative when
        # present; the constructor's list is the bootstrap fallback
        cfg_set = support.bundle().orderer.consenters()
        if cfg_set:
            peer_ids = list(cfg_set)
        self._raft = RaftNode(node_id, peer_ids, transport, wal_path,
                              self._apply, election_timeout, heartbeat_s,
                              rng=rng,
                              snapshot_interval=snapshot_interval,
                              snapshot_cb=self._snapshot_state,
                              install_cb=self._install_snapshot,
                              clock=clock, pipeline=pipeline,
                              queue_cap=queue_cap,
                              group_commit=group_commit)
        if cfg_set and node_id not in cfg_set:
            # configured out (or not yet in): observe, never campaign
            self._raft.member = False
        transport.register(f"{node_id}:chain", self._on_chain_msg)
        self._bounded = submit_queue_cap > 0
        self._q: "queue.Queue[Optional[_Submit]]" = queue.Queue(
            submit_queue_cap if self._bounded else SUBMIT_QUEUE_CAP)
        # accepted submits caught by a leaderless window or a full
        # queue are parked, not dropped (their clients got success).
        # _parked is the run loop's own; _overflow takes forwarded
        # submits arriving on transport threads; a submit past both
        # bounds is dropped and counted
        self._parked: List[_Submit] = []
        self._overflow: "deque[_Submit]" = deque()
        self._overflow_lock = threading.Lock()
        self.dropped = 0
        self.forwarded = 0
        self._halted = threading.Event()
        self._thread = RegisteredThread(target=self._run,
                                        name=f"raftchain[{node_id}]",
                                        structure="orderer.raftchain")
        # applied-index recovery: a restart replaying the WAL skips the
        # entries already in the block store (reference: etcdraft's
        # appliedIndex in the block metadata)
        self._applied_upto = self._tip_raft_index(support.store)

    # -- consenter surface ------------------------------------------------
    def start(self) -> None:
        self._raft.start()
        self._thread.start()

    def halt(self) -> None:
        if self._halted.is_set():
            return
        self._halted.set()
        try:
            # a wakeup only: a blocking put on a full queue would wait
            # on a loop that already exited on _halted
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self._raft.stop()

    def wait_ready(self) -> None:
        if self._halted.is_set():
            raise ChainHaltedError("chain is halted")

    @property
    def is_leader(self) -> bool:
        return self._raft.state == LEADER

    @property
    def leader_id(self) -> Optional[str]:
        return self._raft.leader_id

    @property
    def raft(self) -> RaftNode:
        return self._raft

    def order(self, env: m.Envelope, config_seq: int) -> None:
        self._admission_check()
        self._enqueue_submit(_Submit(env.encode(), False, config_seq),
                             is_config=False)

    def configure(self, env: m.Envelope, config_seq: int) -> None:
        self._admission_check()
        self._check_membership_change(env)
        self._enqueue_submit(_Submit(env.encode(), True, config_seq),
                             is_config=True)

    def submit_queue_depth(self):
        """(qsize, maxsize): the occupancy the overload gate watches."""
        return self._q.qsize(), self._q.maxsize

    def _enqueue_submit(self, sub: _Submit, is_config: bool) -> None:
        """Bounded: a full queue sheds a normal tx typed instead of
        blocking the submitter; config and priority envelopes (decoded
        and classified only on the full path) wait for room."""
        if not self._bounded:
            self._q.put(sub)
            return
        if is_config:
            self._put_priority(sub)
            return
        try:
            self._q.put_nowait(sub)
        except queue.Full:
            try:
                env = m.Envelope.decode(sub.env_bytes)
            except Exception:
                env = None
            if env is not None and admission.is_priority(env):
                self._put_priority(sub)
                return
            raise admission.shed(
                "queue_full", f"submit queue full ({self._q.maxsize})",
                retry_after_s=min(5.0, self._support.batch_timeout_s()),
            ) from None

    def _put_priority(self, sub: _Submit) -> None:
        """A blocking put in slices that re-check the halt."""
        while True:
            if self._halted.is_set():
                raise ChainHaltedError("chain is halted")
            try:
                self._q.put(sub, timeout=0.25)
                return
            except queue.Full:
                continue

    def _admission_check(self) -> None:
        """Refuse, typed and retryable, a submission this node can
        neither order nor forward: a follower with a live leader takes
        it and forwards (reference: Submit :494); only a leaderless
        window refuses (reference: etcdraft's ErrNoLeader)."""
        self.wait_ready()
        faults.point("orderer.raft.submit")
        if self.is_leader:
            return
        lead = self._raft.leader_id
        if lead is None or lead == self.node_id:
            raise NotLeaderError(
                f"consenter {self.node_id!r} has no raft leader to "
                f"forward to (election in progress)", leader_hint=None)

    def _check_membership_change(self, env: m.Envelope) -> None:
        """Refuse a consenter-set change touching more than one member:
        single-server reconfiguration keeps the old and new quorums
        overlapping (reference: etcdraft's CheckConfigMetadata)."""
        try:
            payload = protoutil.unmarshal_envelope_payload(env)
            cenv = m.ConfigEnvelope.decode(payload.data)
            if cenv.config is None:
                return
            from fabric_mod_tpu_torch.channelconfig import Bundle
            new_bundle = Bundle(self._support.channel_id, cenv.config,
                                self._support._csp)
            new_set = set(new_bundle.orderer.consenters())
        except Exception:
            return                         # unreadable: validation rejects
        if not new_set:
            return                         # the channel tracks no set
        cur = set(self._current_consenters())
        if not cur:
            return
        if len(cur ^ new_set) > 1:
            raise ValueError(
                "consenter reconfiguration must add or remove at most "
                f"one member per config update (got {sorted(cur)} -> "
                f"{sorted(new_set)})")

    def _current_consenters(self):
        got = self._support.bundle().orderer.consenters()
        return got if got else tuple([self.node_id] + list(self._raft.peers))

    # -- submit routing ----------------------------------------------------
    def _on_chain_msg(self, src: str, msg) -> None:
        if isinstance(msg, _Submit):
            try:
                self._q.put_nowait(msg)
            except queue.Full:
                # the follower already accepted this submit: park it
                # for the run loop; only past the parked bound is one
                # dropped, and counted
                with self._overflow_lock:
                    if len(self._overflow) < self._PARKED_CAP:
                        self._overflow.append(msg)
                        return
                self.dropped += 1
                admission.chain_drop_counter().with_labels(
                    "forward").add(1)

    # -- the leader loop (reference: chain.go:533 run) --------------------
    def _propose_batch(self, envs: List[m.Envelope], kind: int,
                       config_seq: int) -> None:
        """Propose; on a leadership loss between the check and the
        proposal, requeue the envelopes so they are forwarded to the new
        leader.  While still leader, a full FSM queue is retried with a
        short hold-off (backpressure: the submit queue fills behind)."""
        data = _encode_batch(envs, kind)
        while not self._halted.is_set():
            if self._raft.propose(data):
                return
            if not self.is_leader:
                break                      # leadership lost: unwind
            time.sleep(0.005)              # FSM queue full: hold off
        self._requeue(envs, kind, config_seq)

    def _propose_normal_batches(self, batches: List[List[m.Envelope]],
                                config_seq: int) -> None:
        """With `pipeline` > 0, every batch this submission cut enters
        the raft log in one FSM turn (`propose_many`: one barrier, one
        replication broadcast); otherwise one proposal per batch."""
        if len(batches) > 1 and self._pipeline > 0:
            datas = [_encode_batch(b, _NORMAL) for b in batches]
            while not self._halted.is_set():
                if self._raft.propose_many(datas):
                    return
                if not self.is_leader:
                    break                  # leadership lost: unwind all
                time.sleep(0.005)          # FSM queue full: hold off
            for batch in batches:
                self._requeue(batch, _NORMAL, config_seq)
            return
        for batch in batches:
            self._propose_batch(batch, _NORMAL, config_seq)

    def _requeue(self, envs: List[m.Envelope], kind: int,
                 config_seq: int) -> None:
        subs = [_Submit(env.encode(), kind == _CONFIG, config_seq)
                for env in envs]
        for i, sub in enumerate(subs):
            try:
                self._q.put_nowait(sub)
            except queue.Full:
                rest = subs[i:]
                space = max(0, self._PARKED_CAP - len(self._parked))
                self._parked.extend(rest[:space])
                lost = max(0, len(rest) - space)
                if lost:
                    self.dropped += lost
                    admission.chain_drop_counter().with_labels(
                        "requeue").add(lost)
                break

    def _run(self) -> None:
        support = self._support
        timer_deadline: Optional[float] = None
        was_leader = False
        parked = self._parked
        while not self._halted.is_set():
            timeout = 0.05
            if timer_deadline is not None:
                timeout = max(0.0, min(timeout,
                                       timer_deadline - time.monotonic()))
            try:
                sub = self._q.get(timeout=timeout)
            except queue.Empty:
                sub = "tick"
            if sub is None:
                break
            # forwarded submits parked by transport threads come back
            # as slots free
            with self._overflow_lock:
                while self._overflow:
                    try:
                        self._q.put_nowait(self._overflow[0])
                    except queue.Full:
                        break
                    self._overflow.popleft()
            lead = self._raft.leader_id
            if parked and (self.is_leader or
                           (lead is not None and lead != self.node_id)):
                # a route exists again: parked submits go back through
                # the queue (the leader orders them, a follower forwards)
                while parked:
                    try:
                        self._q.put_nowait(parked[0])
                    except queue.Full:
                        break              # keep the rest parked
                    parked.pop(0)
            if not self.is_leader:
                if was_leader:
                    # leadership lost: the pending batch is discarded
                    # (reference: etcdraft discards the cutter on a
                    # soft-state change)
                    support.cutter.cut()
                    was_leader = False
                timer_deadline = None
                # followers forward, never to themselves (a deposed
                # leader still listed as leader would spin)
                if isinstance(sub, _Submit):
                    if lead is not None and lead != self.node_id:
                        self.forwarded += 1
                        self._transport.send(
                            f"{self.node_id}:chain", f"{lead}:chain", sub)
                    elif len(parked) < self._PARKED_CAP:
                        parked.append(sub)  # leaderless: hold, don't drop
                    else:
                        self.dropped += 1
                continue
            was_leader = True
            # -- leader path --
            if isinstance(sub, _Submit):
                try:
                    env = m.Envelope.decode(sub.env_bytes)
                except Exception:
                    continue
                if sub.is_config:
                    if sub.config_seq < support.sequence():
                        try:
                            env, _is_cfg, _seq = \
                                support.reprocess_config(env)
                        except Exception:
                            continue
                    pending = support.cutter.cut()
                    if pending:
                        self._propose_batch(pending, _NORMAL,
                                            sub.config_seq)
                        timer_deadline = None
                    self._propose_batch([env], _CONFIG, sub.config_seq)
                    continue
                if sub.config_seq < support.sequence():
                    try:
                        support.revalidate_normal(env)
                    except Exception:
                        continue
                batches, pending = support.cutter.ordered(env)
                if batches:
                    self._propose_normal_batches(batches, sub.config_seq)
                    timer_deadline = None
                if pending and timer_deadline is None:
                    timer_deadline = (time.monotonic()
                                      + support.batch_timeout_s())
            # the batch timer cuts the pending batch
            if timer_deadline is not None and \
                    time.monotonic() >= timer_deadline:
                timer_deadline = None
                batch = support.cutter.cut()
                if batch:
                    self._propose_batch(batch, _NORMAL, 0)

    # -- snapshots (reference: etcdraft snapshot catch-up) ----------------
    def _snapshot_state(self) -> bytes:
        """A raft snapshot's app-state pointer: the block height (the
        ledger is the state; a lagging node fetches the blocks)."""
        return self._support.store.height.to_bytes(8, "big")

    def _install_snapshot(self, index: int, data: bytes) -> None:
        """Catch this node's chain up to the snapshot's height by
        pulling the blocks (reference: chain.go:880 catchUp); raising
        makes the raft layer refuse the snapshot."""
        target = int.from_bytes(data[:8], "big")
        support = self._support
        h = support.store.height
        if h < target:
            if self._fetch_blocks is None:
                raise RuntimeError("snapshot needs %d..%d but no block "
                                   "fetcher is configured" % (h, target))
            for block in self._fetch_blocks(h, target):
                self._append_fetched(block)
        if support.store.height < target:
            raise RuntimeError("catch-up fetched too few blocks")
        # fetched config blocks may have changed the consenter set: raft
        # membership follows the bundle now installed (this runs on the
        # FSM thread, so at once)
        cfg_set = support.bundle().orderer.consenters()
        if cfg_set:
            self._raft._on_reconfig(list(cfg_set))
        # the fetched tip's recorded raft index is authoritative: WAL
        # entries covering the fetched blocks are skipped
        self._applied_upto = max(self._applied_upto, index,
                                 self._tip_raft_index(support.store))

    def _append_fetched(self, block: m.Block) -> None:
        """Append one pulled block after checking the hash chain and
        the orderer signature against the BlockValidation policy
        (reference: cluster.VerifyBlocks); config blocks go through
        process_config so the bundle follows."""
        from fabric_mod_tpu_torch.peer.mcs import MessageCryptoService
        support = self._support
        store = support.store
        if block.header.number != store.height:
            raise RuntimeError("fetched block out of order")
        if store.height and \
                block.header.previous_hash != store.last_block_hash:
            raise RuntimeError("fetched block breaks the hash chain")
        MessageCryptoService(support.bundle).verify_block(
            support.channel_id, block)
        if self._is_config_block(block):
            envs = protoutil.get_envelopes(block)
            support.process_config(envs[0], block)
        else:
            support.writer.write_block(block)

    @classmethod
    def _tip_raft_index(cls, store) -> int:
        """The raft index recorded in the tip block's metadata (0 when
        no raft-written block is stored yet)."""
        h = store.height
        if h > 1:
            tip = store.get_block_by_number(h - 1)
            md = tip.metadata.metadata if tip.metadata else []
            if len(md) > cls.RAFT_INDEX_MD_SLOT and \
                    md[cls.RAFT_INDEX_MD_SLOT]:
                return int.from_bytes(md[cls.RAFT_INDEX_MD_SLOT], "big")
        return 0

    @staticmethod
    def _is_config_block(block: m.Block) -> bool:
        try:
            envs = protoutil.get_envelopes(block)
            if len(envs) != 1:
                return False
            payload = protoutil.unmarshal_envelope_payload(envs[0])
            ch = m.ChannelHeader.decode(payload.header.channel_header)
            return ch.type == m.HeaderType.CONFIG
        except Exception:
            return False

    # -- apply (every node, in commit order) ------------------------------
    def _apply(self, index: int, data: bytes) -> None:
        """(reference: chain.go:964 apply -> writeBlock :791)"""
        if index <= self._applied_upto:
            return                         # WAL replay of a stored block
        kind, envs = _decode_batch(data)
        support = self._support
        block = support.writer.create_next_block(envs)
        md = block.metadata.metadata
        while len(md) <= self.RAFT_INDEX_MD_SLOT:
            md.append(b"")
        md[self.RAFT_INDEX_MD_SLOT] = index.to_bytes(8, "big")
        if kind == _CONFIG:
            if not self._config_still_valid(envs[0]):
                # every replica skips it alike: a config raced by another
                # at the same sequence, or one whose membership change
                # became multi-member against the current set
                self._applied_upto = index
                return
            before = support.bundle().orderer.consenters()
            support.process_config(envs[0], block)
            after = support.bundle().orderer.consenters()
            if after and set(after) != set(before):
                # membership switches when the config entry applies, at
                # the same log index on every replica
                self._raft.update_peers(after)
        else:
            support.writer.write_block(block)
        self._applied_upto = index

    def _config_still_valid(self, env: m.Envelope) -> bool:
        """Apply-time revalidation, decided alike on every replica: the
        config must advance the sequence by exactly one, and its
        consenter change must still be single-member against the
        current set."""
        try:
            payload = protoutil.unmarshal_envelope_payload(env)
            cenv = m.ConfigEnvelope.decode(payload.data)
            if cenv.config is None or \
                    cenv.config.sequence != self._support.sequence() + 1:
                return False
            self._check_membership_change(env)
            return True
        except Exception:
            return False
