"""BlockRelay: push once-encoded deliver frames down the tree.

The port's copy of fabric_mod_tpu/dissemination/relay.py.  The leader's
DeliverClient commits a block; its frame comes off the BlockFanout ring
(peer/fanout.py: materialized and encoded once) and is pushed to this
node's current tree children over the gossip comm.  Interior peers
verify, commit through the GossipStateProvider buffer, and forward the
same frame bytes to their own children, so what lands at every peer is
byte-identical to a direct orderer pull, at an orderer cost of one
stream per leader.

A frame lost anywhere (a bounded child queue overflowing, a failed
send, a dead interior peer) leaves a gap in the receiver's payload
buffer, which the anti-entropy pull repairs (state.py's missing range
-> node._pull_range, and the quiescent channel's pull tick).  The relay
adds a prod: a child that sees a frame beyond its next needed block
requests the gap at once instead of waiting for the tick.

Per-child queues are bounded (`queue_cap`, the reference's
FABRIC_MOD_TPU_RELAY_QUEUE, default 64): a slow or dead child sheds its
own oldest frames, counted, never blocking the committing thread or the
other children; the dropped range is contiguous at the old end, the
shape one anti-entropy pull repairs.

Threads: the sender loop ("relay-push", one per peer) ships every
child's envelope.  `InProcNetwork.send` runs the child's receive on
that thread, so a relayed frame's envelope verify, MCS verify and
`state.add_block` run on the parent's sender thread; the child's
forward is an enqueue, and its commit runs on its state provider's loop
and commit pipe.

No fallback on the receive path (a deliberate divergence): the
reference's `on_relay` drops a frame on any exception of its decode or
MCS check (reference relay.py:226), which would turn a device error of
the verifier into a silently dropped frame.  Here `on_relay` drops only
what `GossipNode._verified_block` drops — a decode `ValueError` and the
MCS's `BlockVerificationError` — and anything else propagates to the
sender loop, which keeps it in `errors` and stops.  A push and a repair
prod are the "relay.push" and "relay.repair" spans (tracer armed);
metrics are left out.  The reference's fault points are here: an
armed `dissemination.push` drop loses one child's copy (the repair prod
and anti-entropy recover it), a `dissemination.repair` drop suppresses
the prod (the anti-entropy tick is the backstop).
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredLock, RegisteredThread
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.peer.mcs import BlockVerificationError
from fabric_mod_tpu_torch.protos import messages as m

# the reference's FABRIC_MOD_TPU_RELAY_QUEUE default
QUEUE_CAP = 64
# how long stop() waits for the sender loop to finish its send
JOIN_TIMEOUT_S = 60.0


class BlockRelay:
    """One node's relay engine: root push, interior forward and the
    gap-repair prod.  `tree_source()` returns the current RelayTree
    (recomputed from the live membership view per push, so reparenting
    needs no callback)."""

    # sign-once memo: one frame signs one envelope, reused for every
    # child; small because pushes follow the tip
    _ENV_MEMO = 8

    def __init__(self, node, tree_source: Callable[[], object],
                 queue_cap: int = QUEUE_CAP,
                 on_deliver: Optional[Callable[[int, bytes],
                                               None]] = None):
        self._node = node
        self._tree_source = tree_source
        self._cap = max(1, int(queue_cap))
        self._cid = node._channel.channel_id
        self._lock = RegisteredLock("dissemination.relay._lock")
        self._ready = threading.Condition(self._lock)
        self._queues: Dict[str, collections.deque] = {}
        self._envs: "collections.OrderedDict[int, bytes]" = \
            collections.OrderedDict()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fwd_high = -1            # highest num already forwarded
        self._last_gap_start = -1      # throttles the repair prod
        self.on_deliver = on_deliver   # (num, frame) tap of verified frames
        self.stats: Dict[str, int] = {
            "pushed": 0, "forwarded": 0, "received": 0, "dropped": 0,
            "send_failures": 0, "repair_prods": 0, "duplicates": 0}
        # what ended the sender loop (a child's verifier error among it)
        self.errors: List[BaseException] = []

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = RegisteredThread(target=self._sender_loop,
                                        name="relay-push",
                                        structure="dissemination.relay")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._ready.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=JOIN_TIMEOUT_S)
            if self._thread.is_alive():
                self.errors.append(RuntimeError(
                    "the relay sender loop did not stop"))
            self._thread = None

    def clear(self) -> int:
        """Demotion and promotion teardown: drop every queued frame (the
        children's buffers gap and anti-entropy repairs them).  Returns
        the number of frames discarded."""
        with self._lock:
            n = sum(len(q) for q in self._queues.values())
            self._queues.clear()
            self._envs.clear()
        return n

    # -- push (root and interior alike) -----------------------------------
    def push_frame(self, num: int, frame: bytes,
                   is_config: bool = False) -> int:
        """Enqueue one ready frame toward every current tree child;
        returns the children queued.  Bounded per child: an overflow
        sheds that child's oldest frame, counted."""
        children = self._tree_source().children(self._node.endpoint)
        if not children:
            return 0
        queued = 0
        with self._lock:
            for child in children:
                q = self._queues.get(child)
                if q is None:
                    q = self._queues[child] = collections.deque()
                if len(q) >= self._cap:
                    q.popleft()
                    self.stats["dropped"] += 1
                q.append((num, frame, is_config))
                queued += 1
            if queued:
                self._ready.notify_all()
        return queued

    def _sender_loop(self) -> None:
        try:
            while not self._stop.is_set():
                batch = []
                with self._lock:
                    while not self._stop.is_set():
                        for child, q in self._queues.items():
                            if q:
                                batch.append((child, q.popleft()))
                        if batch:
                            break
                        self._ready.wait(timeout=0.5)
                if self._stop.is_set():
                    return
                for child, (num, frame, is_config) in batch:
                    self._send_one(child, num, frame, is_config)
        except Exception as e:             # kept for the caller; ends here
            self.errors.append(e)

    def _send_one(self, child: str, num: int, frame: bytes,
                  is_config: bool) -> bool:
        if faults.point("dissemination.push"):
            with self._lock:
                self.stats["dropped"] += 1
            return False
        with tracing.span("relay.push", block=num):
            env = self._envelope(num, frame, is_config)
            ok = self._node.comm.send_signed(child, env)
        with self._lock:
            self.stats["pushed" if ok else "send_failures"] += 1
        return ok

    def _envelope(self, num: int, frame: bytes, is_config: bool) -> bytes:
        """Sign once per frame and ship the same envelope to every child
        (degree sends must not mean degree signatures)."""
        with self._lock:
            env = self._envs.get(num)
            if env is not None:
                return env
        msg = m.GossipMessage(
            channel=self._cid.encode(),
            relay_msg=m.RelayMessage(seq_num=num, frame=frame,
                                     config=1 if is_config else 0))
        env = self._node.comm.sign_once(msg)
        with self._lock:
            self._envs[num] = env
            while len(self._envs) > self._ENV_MEMO:
                self._envs.popitem(last=False)
        return env

    # -- receive (wired as GossipNode.on_relay) ---------------------------
    def on_relay(self, msg: m.GossipMessage) -> None:
        """A frame from our tree parent: verify -> commit through the
        state buffer -> forward the same bytes to our children -> prod
        the repair if the frame revealed a gap.  A frame that does not
        decode or fails the MCS is dropped; anything else the checks
        raise propagates (see the module docstring)."""
        rm = msg.relay_msg
        if rm is None or not rm.frame:
            return
        if msg.channel != self._cid.encode():
            return                         # cross-channel guard
        with self._lock:
            self.stats["received"] += 1
        try:
            block = m.DeliverResponse.decode(rm.frame).block
        except ValueError:
            return
        if block is None or block.header is None:
            return
        try:
            # the gate every gossiped block passes before the state
            # buffer (node._handle_data): a relayed frame is as
            # untrusted as any gossiped block
            self._node._channel.mcs.verify_block(self._cid, block)
        except BlockVerificationError:
            return
        num = rm.seq_num
        if self.on_deliver is not None:
            self.on_deliver(num, rm.frame)
        self._node.state.add_block(block)
        with self._lock:
            dup = num <= self._fwd_high
            if not dup:
                self._fwd_high = num
            self.stats["duplicates" if dup else "forwarded"] += 1
        if not dup:
            # verbatim forward: children receive the leader's bytes
            self.push_frame(num, rm.frame, bool(rm.config))
        self._maybe_repair()

    def _maybe_repair(self) -> None:
        """A received frame landed beyond the next needed block: the gap
        exists now, so request it at once instead of waiting for the
        tick.  Throttled per gap head, so a burst of tip frames prods
        once."""
        gap = self._node.state.buffer.missing_range()
        if gap is None:
            with self._lock:
                self._last_gap_start = -1
            return
        with self._lock:
            if gap.start == self._last_gap_start:
                return
            self._last_gap_start = gap.start
            self.stats["repair_prods"] += 1
        with tracing.span("relay.repair", start=gap.start, stop=gap.stop):
            if faults.point("dissemination.repair"):
                return                     # the prod only: the tick heals
            self._node.state.request_gap()
