"""Membership discovery: alive heartbeats + dead-peer expiry.

The port's copy of fabric_mod_tpu/gossip/discovery.py (reference:
gossip/discovery/discovery_impl.go — periodicalSendAlive at :759,
periodicalCheckAlive at :697, expireDeadMembers at :710,
handleAliveMessage's incarnation/sequence freshness at :497).

A deterministic core and an optional background thread:
`tick_send_alive` / `tick_check_alive(now)` drive the logic directly
(tests pass `now=` or a `clock`); `start()` wraps them in a daemon
thread for live nodes.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from fabric_mod_tpu_torch.concurrency import RegisteredThread
from fabric_mod_tpu_torch.protos import messages as m


class MemberInfo:
    __slots__ = ("member", "peertime", "last_seen")

    def __init__(self, member: m.GossipMember, peertime: m.PeerTime,
                 last_seen: float):
        self.member = member
        self.peertime = peertime
        self.last_seen = last_seen


def _fresher(a: m.PeerTime, b: m.PeerTime) -> bool:
    """Is a strictly fresher than b (the incarnation, then the
    sequence)."""
    if a.inc_num != b.inc_num:
        return a.inc_num > b.inc_num
    return a.seq_num > b.seq_num


class Discovery:
    def __init__(self, self_member: m.GossipMember, identity: bytes,
                 comm, expiry_s: float = 5.0,
                 on_expire: Optional[Callable[[bytes], None]] = None,
                 clock: Optional[Callable[[], float]] = None):
        self._self = self_member
        self._self_pki = self_member.pki_id
        self._identity = identity
        self._comm = comm
        self.expiry_s = expiry_s
        self._on_expire = on_expire
        # the liveness clock (wall time unless given)
        self._clock = clock if clock is not None else time.time
        self._inc = int(self._clock() * 1000)
        self._seq = 0
        self._lock = threading.Lock()
        self._members: Dict[bytes, MemberInfo] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- views -----------------------------------------------------------
    def alive_members(self) -> List[m.GossipMember]:
        with self._lock:
            return [info.member for info in self._members.values()]

    def alive_endpoints(self) -> List[str]:
        return [mb.endpoint for mb in self.alive_members()]

    # -- the two periodic duties ----------------------------------------
    def make_alive(self) -> m.GossipMessage:
        self._seq += 1
        return m.GossipMessage(alive_msg=m.AliveMessage(
            membership=self._self,
            timestamp=m.PeerTime(inc_num=self._inc, seq_num=self._seq),
            identity=self._identity))

    def tick_send_alive(self) -> None:
        """(reference: periodicalSendAlive :759)"""
        msg = self.make_alive()
        self._comm.broadcast(self.alive_endpoints(), msg)

    def tick_check_alive(self, now: Optional[float] = None) -> List[bytes]:
        """Expire members not heard from within expiry_s (reference:
        periodicalCheckAlive :697 + expireDeadMembers :710).  Returns
        the expired PKI-IDs."""
        now = now if now is not None else self._clock()
        expired = []
        with self._lock:
            for pid, info in list(self._members.items()):
                if now - info.last_seen > self.expiry_s:
                    del self._members[pid]
                    expired.append(pid)
        for pid in expired:
            if self._on_expire is not None:
                self._on_expire(pid)
        return expired

    # -- inbound ---------------------------------------------------------
    def handle_alive(self, pki_id: bytes, alive: m.AliveMessage,
                     now: Optional[float] = None) -> bool:
        """(reference: handleAliveMessage :497 — only a strictly fresher
        (incarnation, seq) pair updates liveness).  Returns whether the
        message advanced this view (fresh news is worth forwarding)."""
        if alive.membership is None or alive.timestamp is None:
            return False
        if pki_id == self._self_pki:
            return False               # our own forwarded heartbeat
        now = now if now is not None else self._clock()
        with self._lock:
            cur = self._members.get(pki_id)
            if cur is not None and not _fresher(alive.timestamp,
                                                cur.peertime):
                return False
            self._members[pki_id] = MemberInfo(
                alive.membership, alive.timestamp, now)
        return True

    # -- background mode --------------------------------------------------
    def start(self, interval_s: float = 1.0) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                self.tick_send_alive()
                self.tick_check_alive()
        self._thread = RegisteredThread(target=loop, name="discovery-loop",
                                        structure="gossip.discovery")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
