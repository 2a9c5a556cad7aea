"""Gossip service binding: election-driven deliver ownership.

The port's copy of fabric_mod_tpu/gossip/service.py `GossipService`
(reference: gossip/service/gossip_service.go:556 — InitializeChannel
hands the deliver client to the leader-election service, so exactly ONE
peer per org pulls from the ordering service while the others receive
blocks through gossip state transfer; leadership changes start and stop
the client).

  LeaderElectionService (over discovery's alive view)
        │ on_change(is_leader)
        ▼
  DeliverClient(channel, deliver_source)   — started when elected
        │ on_commit(block)
        ▼
  GossipNode.gossip_block                  — the epidemic fan-out to the
                                             others' state buffers, or
  RelayService.on_leader_commit            — with a relay: the block's
                                             frame pushed down the relay
                                             tree (dissemination/)

A demoted leader stops its client; a promoted peer starts one from the
channel's current height.  While a peer leads, a client that ends is
run again from the committed height (the reference's DeliverBlocks
retry loop, blocksprovider.go:141) when it ended cleanly, by a dropped
stream or by a commit race with gossip (the ledger's out-of-order
refusal).  Any other error — the verifier's among them — is kept in
`errors` and ends the loop: the reference logs it and retries.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from fabric_mod_tpu_torch.concurrency import RegisteredLock, RegisteredThread
from fabric_mod_tpu_torch.gossip.election import LeaderElectionService
from fabric_mod_tpu_torch.ledger.kvledger import LedgerError
from fabric_mod_tpu_torch.peer.deliverclient import (DeliverClient,
                                                     DeliverDisconnected)

# how long a leading peer's client waits at the chain tip before it
# ends and is run again
IDLE_TIMEOUT_S = 3600.0


class GossipService:
    """One channel's gossip + election + deliver composition."""

    def __init__(self, node, deliver_source_factory: Callable[[], object],
                 static_leader: Optional[bool] = None,
                 election_interval_s: float = 0.5,
                 relay=None):
        """`node`: a GossipNode.  `deliver_source_factory`: () -> a
        deliver source (orderer/deliver.DeliverService), called afresh on
        every promotion.  `static_leader` pins leadership (the
        reference's static org-leader mode).  `relay`: a
        dissemination.RelayService over the same node, which replaces
        the epidemic push with the tree relay (its `start`, `stop`,
        `on_leadership` and `on_leader_commit` are called here); None
        (the default) pushes epidemically."""
        self._node = node
        self._factory = deliver_source_factory
        self._interval = election_interval_s
        self._client: Optional[DeliverClient] = None
        self._client_thread: Optional[threading.Thread] = None
        self._client_halt: Optional[threading.Event] = None
        self._lock = RegisteredLock("gossip.service._lock")
        self._relay = relay
        self.errors: List[BaseException] = []
        self.election = LeaderElectionService(
            node.pki_id,
            lambda: [mb.pki_id for mb in node.discovery.alive_members()],
            on_change=self._on_leadership,
            static=static_leader)

    @property
    def is_leader(self) -> bool:
        return self.election.is_leader

    @property
    def client(self) -> Optional[DeliverClient]:
        """The running deliver client (None unless this peer leads)."""
        with self._lock:
            return self._client

    def start(self) -> None:
        # the state provider's loop turns a non-leader's gossip receipts
        # into commits: every composed peer runs it
        self._node.state.start()
        if self._relay is not None:
            # the relay accepts frames before any leadership verdict
            self._relay.start()
        # the first verdict before the loop spawns: once the loop runs,
        # it owns ticking
        self.election.tick()
        self.election.start(self._interval)
        # the static-leader path never fires on_change: start the
        # client directly
        if self.election.is_leader:
            if self._relay is not None:
                self._relay.on_leadership(True)
            self._start_client()

    def stop(self) -> None:
        self.election.stop()
        self._stop_client()
        if self._relay is not None:
            self._relay.stop()
        self._node.state.stop()

    # -- leadership transitions -------------------------------------------
    def _on_leadership(self, is_leader: bool) -> None:
        if is_leader:
            if self._relay is not None:
                # rooted before the client's first commit
                self._relay.on_leadership(True)
            self._start_client()
        else:
            self._stop_client()
            if self._relay is not None:
                self._relay.on_leadership(False)

    def _start_client(self) -> None:
        with self._lock:
            if self._client is not None:
                return
            channel = self._node._channel
            on_commit = (self._relay.on_leader_commit
                         if self._relay is not None
                         else self._node.gossip_block)
            client = DeliverClient(channel, self._factory(),
                                   on_commit=on_commit)
            self._client = client
            halt = threading.Event()
            self._client_halt = halt

            def run():
                backoff = 0.2
                while not halt.is_set():
                    try:
                        client.run(idle_timeout_s=IDLE_TIMEOUT_S)
                        # a clean end: stop() (halt is set) or an idle
                        # source; while this peer leads, pull again
                        backoff = 0.2
                        halt.wait(0.05)
                    except (DeliverDisconnected, LedgerError):
                        if halt.is_set():
                            return
                        halt.wait(backoff)
                        backoff = min(2.0, backoff * 2)
                    except Exception as e:     # kept for the caller
                        self.errors.append(e)
                        return

            t = RegisteredThread(target=run, name="gossip-deliver-restart",
                                 structure="gossip.service")
            self._client_thread = t
            t.start()

    def _stop_client(self) -> None:
        with self._lock:
            client, self._client = self._client, None
            thread, self._client_thread = self._client_thread, None
            halt, self._client_halt = self._client_halt, None
        if halt is not None:
            # before client.stop(): the loop must see the halt when run()
            # returns, or it would run the stopped client again
            halt.set()
        if thread is not None:
            # re-issue stop() until the thread exits: a run() that had
            # already started clears the client's stop flag (the client
            # is reusable), so one stop() landing in that window would
            # be lost
            deadline = time.monotonic() + 10.0
            while thread.is_alive() and time.monotonic() < deadline:
                if client is not None:
                    client.stop()
                thread.join(timeout=0.5)
            if thread.is_alive():
                self.errors.append(RuntimeError(
                    "the deliver client did not stop"))
        elif client is not None:
            client.stop()
