"""Seeded churn planning: the deterministic event schedule of a soak.

The port's copy of fabric_mod_tpu/soak/plan.py, pure Python: the same
seed gives the reference's schedule bit for bit.

(reference evaluation model: Basiri et al., "Chaos Engineering", IEEE
Software 2016 — steady-state invariants asserted while deliberately
perturbing the system — and the Jepsen test harness's generator of
nemesis operations interleaved with client traffic.  The schedule is
a pure function of the seed so a failed run can be REPLAYED: the
failure report prints the seed and the exact schedule, and
`ChurnPlan(seed)` regenerates it bit-for-bit.)

Event catalog (each kind exercises a different recovery mechanism at
system scale):

  peer_join        a fresh peer joins mid-run and catches up through
                   gossip anti-entropy state transfer
  acl_revoke       a config update removes the audit org — its live
                   event-deliver subscription must be cut FORBIDDEN
                   mid-stream, never grandfathered
  batch_config     an orderer config update (BatchSize) lands under
                   load — block cutting re-shapes while txs flow
  consenter_add    a new consenter is admitted via config and a fresh
                   replica boots from genesis and catches up
  consenter_remove a consenter (preferring an already-dead one — the
                   operator repair) is configured out
  leader_kill      the raft leader is halted mid-traffic; the
                   survivors re-elect and ordering continues

Crash-shaped kinds (each is down-then-up WITHIN one event, so the
member/live bookkeeping is unchanged after it completes):

  peer_crash_rejoin  a peer is hard-crashed (no flush, no clean close)
                     and a fresh peer reopens the SAME durable ledger
                     dirs — KvLedger._recover replays statedb-behind-
                     blockstore and gossip/relay reconverges the tail
  orderer_restart    a live orderer is halted mid-traffic and a fresh
                     Registrar boots from its existing WAL dir — torn
                     tails cropped, HardState honored, catch-up via
                     AppendEntries repair; quorum must hold while it
                     is down (leader_kill's precondition)
  network_partition  a symmetric partition (peer group + minority
                     orderer group) is installed, traffic flows, then
                     the partition heals on schedule — convergence is
                     gated by the same fingerprint window

The planner tracks (members, live_members) so a generated schedule can
never break raft quorum: leader_kill / consenter_remove are only
scheduled while a majority of the post-event member set stays live,
and orderer_restart only while the restart window can be survived.
"""
from __future__ import annotations

import json
import random
from typing import List, Optional, Sequence, Tuple

EVENT_KINDS = ("peer_join", "acl_revoke", "batch_config",
               "consenter_add", "consenter_remove", "leader_kill",
               "peer_crash_rejoin", "orderer_restart",
               "network_partition")

# the kinds the acceptance gate requires every default run to execute
# (consenter_add and consenter_remove are one "membership change"
# family; both are in the default core so joins and repairs are each
# exercised; the three crash-shaped kinds are core so the recovery
# paths they exercise run on every default soak)
CORE_KINDS = ("peer_join", "acl_revoke", "batch_config",
              "consenter_add", "leader_kill", "consenter_remove",
              "peer_crash_rejoin", "orderer_restart",
              "network_partition")


class ChurnEvent:
    """One scheduled perturbation: fire after `gap_txs` more mixed
    workload transactions have been submitted."""

    __slots__ = ("kind", "gap_txs")

    def __init__(self, kind: str, gap_txs: int):
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown churn event kind {kind!r}")
        self.kind = kind
        self.gap_txs = gap_txs

    def to_dict(self) -> dict:
        return {"kind": self.kind, "gap_txs": self.gap_txs}

    def __eq__(self, other) -> bool:
        return (isinstance(other, ChurnEvent) and
                self.kind == other.kind and
                self.gap_txs == other.gap_txs)

    def __repr__(self) -> str:
        return f"ChurnEvent({self.kind!r}, gap_txs={self.gap_txs})"


def _majority(n: int) -> int:
    return n // 2 + 1


class _PlanState:
    """Safety bookkeeping while generating (mirrors what the harness
    will do at runtime, conservatively)."""

    def __init__(self, members: int, max_peer_joins: int):
        self.members = members             # configured consenter count
        self.live_members = members        # consenters not yet killed
        self.audit_revoked = False
        self.peer_joins_left = max_peer_joins

    def allowed(self, kind: str) -> bool:
        if kind in ("leader_kill", "orderer_restart",
                    "network_partition"):
            # after the kill (or during the restart's down window /
            # the partition's hold) a majority of the UNCHANGED
            # member set must remain live-and-connected or ordering
            # halts for good (the partition cuts one voting orderer
            # to the minority side)
            return self.live_members - 1 >= _majority(self.members)
        if kind == "consenter_remove":
            if self.members <= 2:
                return False
            dead = self.members - self.live_members
            live_after = (self.live_members if dead > 0
                          else self.live_members - 1)
            return live_after >= _majority(self.members - 1)
        if kind == "acl_revoke":
            return not self.audit_revoked
        if kind == "peer_join":
            return self.peer_joins_left > 0
        # batch_config, consenter_add, peer_crash_rejoin (down-then-up
        # on the ledger side only — never an ordering-quorum concern)
        return True

    def apply(self, kind: str) -> None:
        if kind == "leader_kill":
            self.live_members -= 1
        elif kind == "consenter_add":
            self.members += 1
            self.live_members += 1
        elif kind == "consenter_remove":
            dead = self.members - self.live_members
            self.members -= 1
            if dead == 0:
                # runtime prefers removing a dead member; with none,
                # a live one becomes an observer (still serving
                # deliver, no longer voting)
                self.live_members -= 1
        elif kind == "acl_revoke":
            self.audit_revoked = True
        elif kind == "peer_join":
            self.peer_joins_left -= 1
        # peer_crash_rejoin / orderer_restart / network_partition end
        # with the pre-event member and liveness sets restored — the
        # down window's safety is the allowed() precondition


class ChurnPlan:
    """A seeded, replayable schedule of churn events.

    `ChurnPlan(seed, n_events)` is a pure function: the same arguments
    produce the same schedule on every run and every host (the replay
    contract a failed soak's report relies on)."""

    def __init__(self, seed: int, n_events: int = 6,
                 gap_txs: Tuple[int, int] = (4, 9),
                 members: int = 3, max_peer_joins: int = 2,
                 kinds: Optional[Sequence[str]] = None):
        self.seed = int(seed)
        self.n_events = int(n_events)
        rng = random.Random(self.seed)
        state = _PlanState(members, max_peer_joins)
        core = [k for k in (kinds or CORE_KINDS)]
        rng.shuffle(core)
        pool = list(kinds or EVENT_KINDS)
        self.events: List[ChurnEvent] = []
        for _ in range(self.n_events):
            # cover every core kind first, then draw from the pool;
            # a kind whose safety precondition fails yields its slot
            # to the next candidate (deterministically)
            cand = ([k for k in core if state.allowed(k)] or
                    [k for k in pool if state.allowed(k)])
            if not cand:
                break                      # fully constrained: stop
            kind = cand[0] if core else rng.choice(cand)
            if core and kind in core:
                core.remove(kind)
            state.apply(kind)
            self.events.append(
                ChurnEvent(kind, rng.randint(*gap_txs)))

    def kinds(self) -> List[str]:
        return [e.kind for e in self.events]

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [e.to_dict() for e in self.events]},
                          sort_keys=True)

    def describe(self) -> str:
        """The replay block a failed run prints (satellite contract:
        seed + exact schedule + the command that reruns it)."""
        return ("soak seed {s}: replay with `SoakHarness(SoakConfig("
                "seed={s}, n_events={n})).run()`\n"
                "schedule: {j}").format(s=self.seed, n=self.n_events,
                                        j=self.to_json())

    def __eq__(self, other) -> bool:
        return (isinstance(other, ChurnPlan) and
                self.to_json() == other.to_json())
