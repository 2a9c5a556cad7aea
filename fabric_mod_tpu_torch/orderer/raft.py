"""Raft consensus for the ordering service.

The port's copy of fabric_mod_tpu/orderer/raft.py: the messages (:50),
`RaftTransport` (:108), `RaftWAL` (:139) and `RaftNode` (:358)
(reference: orderer/consensus/etcdraft — the etcd/raft library driven by
chain.go:533's single-threaded FSM loop, WAL and snapshot storage in
storage.go, leader-side block proposing at :791/:860).  A compact Raft
with the protocol's rules: randomized election timeouts, term and vote
persistence, log matching, the leader commit rule (only entries of the
current term, by counting replicas), follower log repair by
decrementing next_index, snapshots with a catch-up margin.

As in the reference:
* the replicated payload is a whole cut batch (the leader cuts;
  followers never re-cut), so apply is deterministic across nodes
  whatever their local timers;
* the transport is a seam; only the in-process `RaftTransport` is
  ported (the gRPC cluster transport, orderer/cluster.py, is not);
* one FSM thread per node (chain.go:533): one queue carries timer
  wakeups, peer messages and local proposals, and every state
  transition happens on that thread;
* term, vote and log survive restarts in a CRC-framed WAL whose frames
  are byte-for-byte the reference's, so either package replays the
  other's file.

The reference's knobs are constructor arguments with their defaults:
`pipeline` (FABRIC_MOD_TPU_RAFT_PIPELINE, 0), `queue_cap`
(FABRIC_MOD_TPU_RAFT_QUEUE, 8192) and `group_commit`
(FABRIC_MOD_TPU_WAL_GROUP_COMMIT, off: an fsync on every append).  Its
fault points are at the reference's places (`orderer.wal.sync` drops a
barrier's fsync, `orderer.wal.crash` kills an append after the frame
write, `orderer.raft.replicate` drops a pipelined window); its
race-check wrappers are left out; a node counts its
dropped messages (also in the admission module's chain drop counter,
reference :450-510), its elections and the leader changes it saw in
plain attributes.  A WAL barrier is the "wal.sync" span and a pipelined
append window "raft.replicate" (tracer armed).
"""
from __future__ import annotations

import os
import queue
import random
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.orderer.admission import chain_drop_counter

# --- messages (wire-shaped; a cluster Step stream would carry these) -------


class RequestVote:
    __slots__ = ("term", "candidate", "last_log_index", "last_log_term")

    def __init__(self, term, candidate, last_log_index, last_log_term):
        self.term = term
        self.candidate = candidate
        self.last_log_index = last_log_index
        self.last_log_term = last_log_term


class VoteReply:
    __slots__ = ("term", "voter", "granted")

    def __init__(self, term, voter, granted):
        self.term = term
        self.voter = voter
        self.granted = granted


class AppendEntries:
    __slots__ = ("term", "leader", "prev_index", "prev_term", "entries",
                 "leader_commit")

    def __init__(self, term, leader, prev_index, prev_term, entries,
                 leader_commit):
        self.term = term
        self.leader = leader
        self.prev_index = prev_index
        self.prev_term = prev_term
        self.entries = entries          # [(term, bytes)]
        self.leader_commit = leader_commit


class AppendReply:
    __slots__ = ("term", "follower", "success", "match_index")

    def __init__(self, term, follower, success, match_index):
        self.term = term
        self.follower = follower
        self.success = success
        self.match_index = match_index


class InstallSnapshot:
    """Leader -> lagging follower state transfer when the entries the
    follower needs were compacted away (reference: etcdraft snapshot
    catch-up, chain.go:880 + storage.go:299 TakeSnapshot)."""

    __slots__ = ("term", "leader", "last_index", "last_term", "data")

    def __init__(self, term, leader, last_index, last_term, data):
        self.term = term
        self.leader = leader
        self.last_index = last_index   # last raft index the snapshot covers
        self.last_term = last_term
        self.data = data               # app-defined state pointer


class RaftTransport:
    """node_id -> handler(src, msg), in process.  A node id in
    `partitioned` neither sends nor receives (the tests' crash and
    partition model)."""

    def __init__(self):
        self._handlers: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self.partitioned: set = set()

    def register(self, node_id: str, handler: Callable) -> None:
        with self._lock:
            self._handlers[node_id] = handler

    def send(self, src: str, dst: str, msg) -> None:
        with self._lock:
            if src in self.partitioned or dst in self.partitioned:
                return
            handler = self._handlers.get(dst)
        if handler is not None:
            try:
                handler(src, msg)
            except Exception:
                pass                       # a lost message; raft resends


# --- WAL -------------------------------------------------------------------

_HARDSTATE, _ENTRY, _SNAPSHOT = 0, 1, 2


class RaftWAL:
    """Append-only persistence of (term, voted_for), log entries and
    snapshot markers (reference: etcd WAL via storage.go:244; the same
    crash contract: a torn tail is cropped by the CRC framing).

    A frame is <u32 length><u32 crc32><payload>; a payload is one kind
    byte then a hard state (<q term><I len><voted_for>), an entry
    (<q term><q index><data>) or a snapshot marker (<q snap_index>
    <q snap_term><q base><q base_term><data>).

    A snapshot marker says "entries <= snap_index are folded into the
    app state"; `compact` rewrites the file to a marker plus the kept
    suffix.  Compaction keeps a margin of entries behind snap_index, so
    a slightly lagging follower is repaired by AppendEntries and not a
    snapshot: entries[i] holds raft index base + i + 1, with
    base <= snap_index <= last_index.

    `group_commit` False (the reference's default) syncs every append
    inline.  True writes the frame buffered and defers the fsync to the
    next `sync()` barrier, which the node places before every ack (a
    follower's AppendReply, the leader counting itself), so the crash
    contract holds in both modes.  `sync_count` counts physical
    fsyncs."""

    def __init__(self, path: str, group_commit: bool = False):
        self._path = path
        self.term = 0
        self.voted_for: Optional[str] = None
        self.snap_index = 0
        self.snap_term = 0
        self.snap_data = b""
        self.base = 0            # index of the entry before entries[0]
        self.base_term = 0
        self.entries: List[Tuple[int, bytes]] = []
        self._group = bool(group_commit)
        self._dirty = False
        self.sync_count = 0
        if os.path.exists(path):
            self._replay()
        self._f = open(path, "ab")

    def _replay(self) -> None:
        with open(self._path, "rb") as f:
            raw = f.read()
        pos = 0
        good_end = 0
        while pos + 8 <= len(raw):
            ln, crc = struct.unpack_from("<II", raw, pos)
            end = pos + 8 + ln
            if end > len(raw):
                break
            payload = raw[pos + 8:end]
            if zlib.crc32(payload) != crc:
                break
            kind = payload[0]
            if kind == _HARDSTATE:
                (self.term,) = struct.unpack_from("<q", payload, 1)
                (vl,) = struct.unpack_from("<I", payload, 9)
                self.voted_for = (payload[13:13 + vl].decode()
                                  if vl else None)
            elif kind == _ENTRY:
                eterm, upto = struct.unpack_from("<qq", payload, 1)
                data = payload[17:]
                # upto = the index this entry lands at; a conflicting
                # suffix is truncated (log repair happened before write)
                local = upto - self.base
                if local >= 1:
                    del self.entries[local - 1:]
                    self.entries.append((eterm, data))
            elif kind == _SNAPSHOT:
                (sidx, sterm, base,
                 bterm) = struct.unpack_from("<qqqq", payload, 1)
                self.snap_index = sidx
                self.snap_term = sterm
                self.base = base
                self.base_term = bterm
                self.snap_data = payload[33:]
                self.entries = []
            good_end = end
            pos = end
        if good_end < len(raw):
            with open(self._path, "r+b") as f:
                f.truncate(good_end)

    def _frame(self, payload: bytes) -> bytes:
        return struct.pack("<II", len(payload),
                           zlib.crc32(payload)) + payload

    # -- index helpers (1-based raft indices) ----------------------------
    @property
    def last_index(self) -> int:
        return self.base + len(self.entries)

    def term_at(self, index: int) -> int:
        """Term of `index`; only valid for base <= index <= last."""
        if index == self.base:
            return self.base_term
        return self.entries[index - self.base - 1][0]

    def entry(self, index: int) -> Tuple[int, bytes]:
        return self.entries[index - self.base - 1]

    def entries_from(self, index: int, limit: int) -> List[Tuple[int, bytes]]:
        s = index - self.base - 1
        return self.entries[s:s + limit]

    # -- writes -----------------------------------------------------------
    def sync(self) -> None:
        """The barrier: flush and one fsync make every frame written
        since the last barrier durable; a no-op when nothing is
        pending."""
        if not self._dirty:
            return
        with tracing.span("wal.sync"):
            if faults.point("orderer.wal.sync"):
                return                     # the injected lost fsync
            self._f.flush()
            os.fsync(self._f.fileno())
            self.sync_count += 1
            self._dirty = False

    def save_hardstate(self, term: int, voted_for: Optional[str]) -> None:
        self.term = term
        self.voted_for = voted_for
        v = (voted_for or "").encode()
        payload = (bytes([_HARDSTATE]) + struct.pack("<q", term)
                   + struct.pack("<I", len(v)) + v)
        self._f.write(self._frame(payload))
        # term and vote are durable before any message acts on them
        # (election safety), in either mode; the one fsync also covers
        # entries buffered before it
        self._dirty = True
        self.sync()

    def append(self, index: int, term: int, data: bytes) -> None:
        """Write the entry at 1-based `index`, truncating conflicts.
        Group commit defers the fsync to the caller's `sync()`."""
        local = index - self.base
        if local < 1:
            return                         # already folded into snapshot
        del self.entries[local - 1:]
        self.entries.append((term, data))
        payload = (bytes([_ENTRY]) + struct.pack("<qq", term, index)
                   + data)
        self._f.write(self._frame(payload))
        # crash seam: after the frame write, before any ack is built on
        # it — the torn-tail window a restart's replay crops
        faults.point("orderer.wal.crash")
        self._dirty = True
        if not self._group:
            self.sync()

    def _rewrite(self, snap_index: int, snap_term: int, snap_data: bytes,
                 base: int, base_term: int,
                 keep: List[Tuple[int, bytes]]) -> None:
        """Replace the file atomically: hard state, snapshot marker and
        the kept entries (absolute indices base+1...)."""
        tmp = self._path + ".compact"
        with open(tmp, "wb") as f:
            v = (self.voted_for or "").encode()
            f.write(self._frame(bytes([_HARDSTATE])
                                + struct.pack("<q", self.term)
                                + struct.pack("<I", len(v)) + v))
            f.write(self._frame(bytes([_SNAPSHOT])
                                + struct.pack("<qqqq", snap_index,
                                              snap_term, base, base_term)
                                + snap_data))
            for i, (eterm, data) in enumerate(keep):
                f.write(self._frame(bytes([_ENTRY])
                                    + struct.pack("<qq", eterm,
                                                  base + i + 1)
                                    + data))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self._path)
        self._f = open(self._path, "ab")
        self._dirty = False       # the rewrite fsynced everything kept
        self.snap_index = snap_index
        self.snap_term = snap_term
        self.snap_data = snap_data
        self.base = base
        self.base_term = base_term
        self.entries = keep

    def compact(self, upto: int, term: int, data: bytes,
                margin: int = 0) -> None:
        """Record a snapshot at `upto` (which must be applied) and drop
        entries <= upto - margin; the margin stays for AppendEntries
        repair of slightly lagging followers."""
        if upto <= self.snap_index:
            return
        new_base = max(self.base, upto - margin)
        keep = self.entries[new_base - self.base:]
        self._rewrite(upto, term, data,
                      new_base, self.term_at(new_base), keep)

    def install_snapshot(self, index: int, term: int, data: bytes) -> None:
        """Replace the whole log with a received snapshot."""
        self._rewrite(index, term, data, index, term, [])

    def close(self) -> None:
        self.sync()               # a graceful stop loses nothing buffered
        self._f.close()


# --- the node --------------------------------------------------------------

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RaftNode:
    """One replica.  `apply_cb(index, data)` fires exactly once per
    committed entry, in order, on the FSM thread.

    `pipeline` > 0 sends up to that many windows of
    MAX_ENTRIES_PER_APPEND entries ahead of a follower's acks (0: one
    round per reply).  `queue_cap` bounds the FSM queue (0: unbounded);
    a peer message that finds it full is dropped and counted (raft
    resends), a proposal is refused.  `group_commit` is the WAL's.
    `clock` (with `monotonic()`, optionally `subscribe(cb)`) replaces
    time.monotonic for the election and heartbeat deadlines; with a
    manual clock and seeded `rng`s, elections are deterministic."""

    def __init__(self, node_id: str, peers: List[str],
                 transport: RaftTransport, wal_path: str,
                 apply_cb: Callable[[int, bytes], None],
                 election_timeout: Tuple[float, float] = (0.15, 0.3),
                 heartbeat_s: float = 0.05,
                 rng: Optional[random.Random] = None,
                 snapshot_interval: Optional[int] = None,
                 snapshot_cb: Optional[Callable[[], bytes]] = None,
                 install_cb: Optional[Callable[[int, bytes], None]] = None,
                 clock=None, pipeline: int = 0, queue_cap: int = 8192,
                 group_commit: bool = False):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self._transport = transport
        self._wal = RaftWAL(wal_path, group_commit=group_commit)
        self._apply = apply_cb
        self._eto = election_timeout
        self._hb = heartbeat_s
        self._rng = rng or random.Random()
        # snapshots (reference: SnapshotIntervalSize, storage.go:299):
        # every `snapshot_interval` applied entries snapshot_cb() gives
        # an app-state pointer and the log is compacted up to
        # last_applied; install_cb(index, data) must catch the app
        # state up when a snapshot arrives from the leader
        self._snap_every = snapshot_interval
        self._snap_margin = (min(self.SNAPSHOT_CATCHUP_ENTRIES,
                                 snapshot_interval // 2)
                             if snapshot_interval else 0)
        self._snapshot_cb = snapshot_cb
        self._install_cb = install_cb

        self.state = FOLLOWER
        self.member = True                 # False once reconfigured out
        self.leader_id: Optional[str] = None
        self.commit_index = self._wal.snap_index
        self.last_applied = self._wal.snap_index
        self._votes: set = set()
        self._next_index: Dict[str, int] = {}
        self._match_index: Dict[str, int] = {}
        self._snap_sent: Dict[str, float] = {}
        # optimistic pipelining: _opt_next[p] is the first index not yet
        # sent to p (>= the acked _next_index); replies repair it
        self._pipeline = max(0, int(pipeline))
        self._opt_next: Dict[str, int] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=max(0, int(queue_cap)))
        # counters: peer messages dropped on a full queue, elections
        # this node started, leader changes it saw
        self.dropped = 0
        self.elections = 0
        self.leader_changes = 0
        self._stop = threading.Event()
        self._deadline = 0.0
        if clock is None:
            self._now = time.monotonic
        else:
            self._now = clock.monotonic
            subscribe = getattr(clock, "subscribe", None)
            if subscribe is not None:
                # a wakeup only: a full queue already wakes the FSM
                subscribe(lambda: self._put_advisory(("noop",)))
        self._thread = RegisteredThread(
            target=self._run, name=f"raft-fsm[{node_id}]",
            structure="orderer.raft")
        transport.register(node_id, self._on_transport_msg)

    # -- queue admission --------------------------------------------------
    def _on_transport_msg(self, src: str, msg) -> None:
        try:
            self._q.put_nowait(("msg", src, msg))
        except queue.Full:
            # heartbeats resend entries, votes re-request on timeout
            self.dropped += 1
            chain_drop_counter().with_labels("raft_msg").add(1)

    def _put_advisory(self, item) -> None:
        """Wakeup-only items: dropping one on a full queue is safe."""
        try:
            self._q.put_nowait(item)
        except queue.Full:
            pass

    # -- public ----------------------------------------------------------
    def start(self) -> None:
        self._reset_election_timer()
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._put_advisory(("noop",))
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self._wal.close()

    @property
    def wal_syncs(self) -> int:
        """The WAL's physical fsyncs so far."""
        return self._wal.sync_count

    def propose(self, data: bytes) -> bool:
        """Leader only; False when not the leader or when the FSM queue
        is full (the caller forwards to `leader_id` or requeues —
        reference: chain Submit :494)."""
        if self.state != LEADER:
            return False
        try:
            self._q.put_nowait(("propose", data))
        except queue.Full:
            chain_drop_counter().with_labels("raft_msg").add(1)
            return False
        return True

    def propose_many(self, datas: List[bytes]) -> bool:
        """Leader-only multi-entry proposal: every entry lands in the
        log in one FSM turn (one barrier, one replication broadcast) or
        none does (False, as `propose`)."""
        if self.state != LEADER:
            return False
        if not datas:
            return True
        try:
            self._q.put_nowait(("propose_many", list(datas)))
        except queue.Full:
            chain_drop_counter().with_labels("raft_msg").add(1)
            return False
        return True

    def update_peers(self, node_ids) -> None:
        """Reconfigure the member set on the FSM thread.  Every replica
        calls this when the same committed config entry applies, so
        membership switches at the same log point (the reference's
        ConfChange-on-config-block model, chain.go's ApplyConfChange).
        Callers change at most one member per config.  Off the FSM
        thread the put blocks (the FSM drains); on it, a full queue
        applies the reconfiguration at once instead."""
        if threading.current_thread() is self._thread:
            try:
                self._q.put_nowait(("reconfig", list(node_ids)))
            except queue.Full:
                self._on_reconfig(list(node_ids))
            return
        self._q.put(("reconfig", list(node_ids)))

    @property
    def last_index(self) -> int:
        return self._wal.last_index

    def _last_term(self) -> int:
        return self._wal.term_at(self._wal.last_index)

    # -- FSM loop (reference: chain.go:533 run) ---------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            timeout = max(0.0, self._deadline - self._now())
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                # the wait is in real time, the deadline in clock time:
                # under a manual clock a real-time expiry fires the
                # timer only if clock time agrees
                if self._now() >= self._deadline:
                    self._on_timer()
                continue
            kind = item[0]
            if kind == "msg":
                self._on_message(item[1], item[2])
            elif kind == "propose":
                self._on_propose(item[1])
            elif kind == "propose_many":
                self._on_propose_many(item[1])
            elif kind == "reconfig":
                self._on_reconfig(item[1])
            # re-check expiry on every wakeup (a manual clock's advance
            # lands here as a noop)
            if self._now() >= self._deadline and not self._stop.is_set():
                self._on_timer()

    def _on_reconfig(self, node_ids) -> None:
        self.member = self.id in node_ids
        self.peers = [p for p in node_ids if p != self.id]
        for gone in [p for p in self._next_index
                     if p not in self.peers]:
            self._next_index.pop(gone, None)
            self._match_index.pop(gone, None)
        if not self.member and self.state == LEADER:
            # a removed leader steps down and observes until halted
            # (reference: the eviction path, chain.go:1335)
            self._step_down(self._wal.term)

    def _reset_election_timer(self) -> None:
        self._deadline = (self._now()
                          + self._rng.uniform(*self._eto))

    def _on_timer(self) -> None:
        if self.state == LEADER:
            self._broadcast_append()
            self._deadline = self._now() + self._hb
        elif self.member:
            self._start_election()
        else:
            self._reset_election_timer()   # observers never campaign

    def _set_leader(self, leader: Optional[str]) -> None:
        if leader is not None and leader != self.leader_id:
            self.leader_changes += 1
        self.leader_id = leader

    # -- elections --------------------------------------------------------
    def _start_election(self) -> None:
        self.elections += 1
        self.state = CANDIDATE
        self._wal.save_hardstate(self._wal.term + 1, self.id)
        self._votes = {self.id}
        self.leader_id = None
        self._reset_election_timer()
        msg = RequestVote(self._wal.term, self.id, self.last_index,
                          self._last_term())
        for p in self.peers:
            self._transport.send(self.id, p, msg)
        self._maybe_win()

    def _maybe_win(self) -> None:
        if self.state == CANDIDATE and \
                len(self._votes) * 2 > len(self.peers) + 1:
            self.state = LEADER
            self._set_leader(self.id)
            self._next_index = {p: self.last_index + 1
                                for p in self.peers}
            self._match_index = {p: 0 for p in self.peers}
            self._opt_next = dict(self._next_index)
            # a no-op barrier entry lets the new leader commit entries
            # of earlier terms under the current-term counting rule
            self._append_local(b"")
            self._wal.sync()               # durable before self-quorum
            self._advance_commit()         # single-node quorum
            self._broadcast_append()
            self._deadline = self._now() + self._hb

    def _step_down(self, term: int) -> None:
        if term > self._wal.term:
            self._wal.save_hardstate(term, None)
        self.state = FOLLOWER
        self._votes = set()
        # a deposed leader stops advertising itself, or submit
        # forwarding would loop back to it
        if self.leader_id == self.id:
            self.leader_id = None
        self._reset_election_timer()

    # -- log machinery ----------------------------------------------------
    def _append_local(self, data: bytes) -> int:
        idx = self.last_index + 1
        self._wal.append(idx, self._wal.term, data)
        return idx

    def _on_propose(self, data: bytes) -> None:
        if self.state != LEADER:
            return
        self._append_local(data)
        self._wal.sync()                   # durable before self-quorum
        self._advance_commit()             # single-node quorum
        self._broadcast_append(optimistic=True)

    def _on_propose_many(self, datas: List[bytes]) -> None:
        if self.state != LEADER:
            return
        for data in datas:
            self._append_local(data)
        self._wal.sync()                   # one barrier for the burst
        self._advance_commit()
        self._broadcast_append(optimistic=True)

    def _broadcast_append(self, optimistic: bool = False) -> None:
        for p in self.peers:
            if optimistic and self._pipeline > 0:
                self._pipeline_append(p)
            else:
                self._send_append(p)

    MAX_ENTRIES_PER_APPEND = 64            # reference: MaxInflightBlocks

    def _send_append(self, peer: str) -> None:
        nxt = self._next_index.get(peer, self.last_index + 1)
        if nxt <= self._wal.base:
            # the entries the follower needs were compacted: ship the
            # snapshot (reference: chain.go:880 catchUp), at most once
            # every 10 heartbeats (installing fetches blocks)
            now = self._now()
            if now - self._snap_sent.get(peer, 0.0) >= 10 * self._hb:
                self._snap_sent[peer] = now
                self._transport.send(self.id, peer, InstallSnapshot(
                    self._wal.term, self.id, self._wal.snap_index,
                    self._wal.snap_term, self._wal.snap_data))
            return
        prev_index = nxt - 1
        prev_term = (self._wal.term_at(prev_index)
                     if (self._wal.base <= prev_index
                         <= self._wal.last_index) else 0)
        # a lagging follower is repaired in bounded chunks
        entries = self._wal.entries_from(nxt, self.MAX_ENTRIES_PER_APPEND)
        self._transport.send(self.id, peer, AppendEntries(
            self._wal.term, self.id, prev_index, prev_term,
            list(entries), self.commit_index))
        self._opt_next[peer] = max(self._opt_next.get(peer, 0),
                                   nxt + len(entries))

    def _pipeline_append(self, peer: str) -> None:
        """Windowed optimistic sends: push the unsent suffix in
        MAX_ENTRIES_PER_APPEND chunks, up to `pipeline` windows beyond
        the acked `_next_index`, without waiting a round trip per
        window.  A lost window is repaired by the heartbeat resend from
        `_next_index` and the failure-reply backoff."""
        nxt = self._next_index.get(peer, self.last_index + 1)
        if nxt <= self._wal.base:
            self._send_append(peer)        # snapshot catch-up path
            return
        opt = max(self._opt_next.get(peer, nxt), nxt)
        limit = min(self.last_index,
                    nxt - 1 + self._pipeline * self.MAX_ENTRIES_PER_APPEND)
        sent_any = False
        while opt <= limit:
            if not (self._wal.base <= opt - 1 <= self._wal.last_index):
                break                      # suffix compacted mid-flight
            entries = self._wal.entries_from(
                opt, min(self.MAX_ENTRIES_PER_APPEND, limit - opt + 1))
            if not entries:
                break
            with tracing.span("raft.replicate"):
                if faults.point("orderer.raft.replicate"):
                    return                 # the injected window drop
                self._transport.send(self.id, peer, AppendEntries(
                    self._wal.term, self.id, opt - 1,
                    self._wal.term_at(opt - 1), list(entries),
                    self.commit_index))
            opt += len(entries)
            self._opt_next[peer] = opt
            sent_any = True
        if not sent_any:
            # nothing new in the window: still carry term and commit
            prev = min(opt, self.last_index + 1) - 1
            if self._wal.base <= prev <= self._wal.last_index:
                self._transport.send(self.id, peer, AppendEntries(
                    self._wal.term, self.id, prev,
                    self._wal.term_at(prev), [], self.commit_index))

    # -- message handling --------------------------------------------------
    def _on_message(self, src: str, msg) -> None:
        if isinstance(msg, RequestVote):
            self._on_request_vote(msg)
        elif isinstance(msg, VoteReply):
            self._on_vote_reply(msg)
        elif isinstance(msg, AppendEntries):
            self._on_append(msg)
        elif isinstance(msg, AppendReply):
            self._on_append_reply(msg)
        elif isinstance(msg, InstallSnapshot):
            self._on_install_snapshot(msg)

    def _on_request_vote(self, msg: RequestVote) -> None:
        if msg.candidate not in self.peers:
            return                         # non-members cannot campaign
        if msg.term > self._wal.term:
            self._step_down(msg.term)
        granted = False
        if msg.term == self._wal.term and \
                self._wal.voted_for in (None, msg.candidate):
            # the candidate's log must be at least as up to date (§5.4.1)
            up_to_date = (msg.last_log_term, msg.last_log_index) >= \
                (self._last_term(), self.last_index)
            if up_to_date:
                granted = True
                self._wal.save_hardstate(self._wal.term, msg.candidate)
                self._reset_election_timer()
        self._transport.send(self.id, msg.candidate, VoteReply(
            self._wal.term, self.id, granted))

    def _on_vote_reply(self, msg: VoteReply) -> None:
        if msg.term > self._wal.term:
            self._step_down(msg.term)
            return
        if self.state == CANDIDATE and msg.term == self._wal.term \
                and msg.granted:
            self._votes.add(msg.voter)
            self._maybe_win()

    def _on_append(self, msg: AppendEntries) -> None:
        if msg.term > self._wal.term or \
                (msg.term == self._wal.term and self.state != FOLLOWER):
            self._step_down(msg.term)
        if msg.term < self._wal.term:
            self._transport.send(self.id, msg.leader, AppendReply(
                self._wal.term, self.id, False, 0))
            return
        self._set_leader(msg.leader)
        self._reset_election_timer()
        # log matching (indices <= snap_index are committed by
        # definition, so matching is checked from there up)
        snap = self._wal.snap_index
        if msg.prev_index > self.last_index:
            # our last index as a repair hint: the leader jumps there
            self._transport.send(self.id, msg.leader, AppendReply(
                self._wal.term, self.id, False, self.last_index))
            return
        if msg.prev_index > snap and msg.prev_index > 0:
            if self._wal.term_at(msg.prev_index) != msg.prev_term:
                self._transport.send(self.id, msg.leader, AppendReply(
                    self._wal.term, self.id, False, msg.prev_index - 1))
                return
        # append, truncating conflicts; entries folded into our
        # snapshot are skipped (already applied state)
        idx = msg.prev_index
        for eterm, data in msg.entries:
            idx += 1
            if idx <= snap:
                continue
            if idx <= self.last_index:
                if self._wal.term_at(idx) == eterm:
                    continue               # already have it
            self._wal.append(idx, eterm, data)
        # durable before the ack the leader commits on
        self._wal.sync()
        if msg.leader_commit > self.commit_index:
            # §5.3: commit at most up to the last entry this message
            # matched or appended
            last_new = msg.prev_index + len(msg.entries)
            self.commit_index = max(self.commit_index,
                                    min(msg.leader_commit, last_new))
            self._apply_committed()
        self._transport.send(self.id, msg.leader, AppendReply(
            self._wal.term, self.id, True, idx))

    def _on_append_reply(self, msg: AppendReply) -> None:
        if msg.term > self._wal.term:
            self._step_down(msg.term)
            return
        if self.state != LEADER or msg.term != self._wal.term:
            return
        if msg.success:
            self._match_index[msg.follower] = max(
                self._match_index.get(msg.follower, 0), msg.match_index)
            self._next_index[msg.follower] = \
                self._match_index[msg.follower] + 1
            self._opt_next[msg.follower] = max(
                self._opt_next.get(msg.follower, 0),
                self._next_index[msg.follower])
            self._advance_commit()
            if self._pipeline > 0 and \
                    self._opt_next[msg.follower] <= self.last_index:
                # an ack freed window room: keep the pipe full
                self._pipeline_append(msg.follower)
        else:
            # repair: back off, straight to the follower's hint when it
            # is further behind (§5.3); optimistic sends past the
            # mismatch are void
            cur = self._next_index.get(msg.follower, self.last_index + 1)
            self._next_index[msg.follower] = max(
                1, min(cur - 1, msg.match_index + 1))
            self._opt_next[msg.follower] = self._next_index[msg.follower]
            self._send_append(msg.follower)

    def _advance_commit(self) -> None:
        """Commit the highest index replicated on a majority whose entry
        is from the current term (§5.4.2)."""
        for n in range(self.last_index,
                       max(self.commit_index, self._wal.snap_index), -1):
            if self._wal.term_at(n) != self._wal.term:
                break
            count = 1 + sum(1 for p in self.peers
                            if self._match_index.get(p, 0) >= n)
            if count * 2 > len(self.peers) + 1:
                self.commit_index = n
                self._apply_committed()
                self._broadcast_append()   # carry the commit index
                break

    def _apply_committed(self) -> None:
        while self.last_applied < self.commit_index:
            nxt = self.last_applied + 1
            _term, data = self._wal.entry(nxt)
            if data:                       # no-op barriers are skipped
                try:
                    self._apply(nxt, data)
                except Exception:
                    # never advance past a failed apply (that would
                    # fork this node's chain); retry on the next commit
                    return
            self.last_applied = nxt
        self._maybe_compact()

    # entries kept behind the snapshot point, so a follower that missed
    # a few messages is repaired by AppendEntries (reference: etcd's
    # SnapshotCatchUpEntries)
    SNAPSHOT_CATCHUP_ENTRIES = 16

    def _maybe_compact(self) -> None:
        """Fold applied entries into a snapshot every
        `snapshot_interval` applies (reference: storage.go:299)."""
        if not self._snap_every or self._snapshot_cb is None:
            return
        if self.last_applied - self._wal.snap_index < self._snap_every:
            return
        try:
            data = self._snapshot_cb()
        except Exception:
            return                         # keep the log; retry later
        self._wal.compact(self.last_applied,
                          self._wal.term_at(self.last_applied), data,
                          margin=self._snap_margin)

    def _on_install_snapshot(self, msg: InstallSnapshot) -> None:
        if msg.term > self._wal.term:
            self._step_down(msg.term)
        if msg.term < self._wal.term:
            self._transport.send(self.id, msg.leader, AppendReply(
                self._wal.term, self.id, False, 0))
            return
        if self.state != FOLLOWER:
            self._step_down(msg.term)
        self._set_leader(msg.leader)
        self._reset_election_timer()
        if msg.last_index <= self.commit_index:
            # nothing to install: say where we are, so the leader
            # resumes AppendEntries from there
            self._transport.send(self.id, msg.leader, AppendReply(
                self._wal.term, self.id, True, self.commit_index))
            return
        # the app must rebuild its state up to last_index (the orderer
        # pulls the missing blocks); refuse otherwise, as accepting
        # would skip committed entries
        if self._install_cb is None:
            self._transport.send(self.id, msg.leader, AppendReply(
                self._wal.term, self.id, False, self.commit_index))
            return
        try:
            self._install_cb(msg.last_index, msg.data)
        except Exception:
            self._transport.send(self.id, msg.leader, AppendReply(
                self._wal.term, self.id, False, self.commit_index))
            return
        self._wal.install_snapshot(msg.last_index, msg.last_term, msg.data)
        self.commit_index = msg.last_index
        self.last_applied = msg.last_index
        self._transport.send(self.id, msg.leader, AppendReply(
            self._wal.term, self.id, True, msg.last_index))
