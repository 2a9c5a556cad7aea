"""Soak invariants: what must stay true under churn, checked loudly.

The port's copy of fabric_mod_tpu/soak/invariants.py: the health
check registers on the port's `default_health()`, the metrics on its
default provider, and the leak sweep reads the port's worker registry
(concurrency.live_registered), where every worker of the port is
registered.

Steady-state hypotheses (the chaos-engineering contract — every one
is asserted after EVERY event and at run end, and a violation raises
SoakError carrying the seed + exact schedule needed to replay):

  convergence   within a bounded recovery window after an event, all
                peers' KvLedger.state_fingerprint() agree at the
                orderer tip on every channel (the state-fingerprint
                differential oracle, promoted to a fleet-wide invariant)
  exactly-once  every envelope the ordering service ACKED commits
                exactly once across the whole run (the broadcaststorm
                ledger audit, extended across churn: txs lost to a
                leader kill are resubmitted at the quiesced tail and
                still count once)
  no-leaks      no registered worker thread outlives the world's
                teardown (concurrency.assert_joined writ run-wide)
  recovery      post-event throughput recovers to at least
                `min_recovery_frac` of the pre-event rate

Observability: per-event-kind recovery-time histograms, an events
counter, and a soak heartbeat gauge on /metrics (the default
provider), so a long soak's liveness is visible from outside.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional

from fabric_mod_tpu_torch.concurrency import live_registered
from fabric_mod_tpu_torch.observability import get_logger, tracing
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)
from fabric_mod_tpu_torch.observability.opsserver import default_health
from fabric_mod_tpu_torch.soak.workload import committed_txids

log = get_logger("soak.invariants")

_RECOVERY_HIST = default_provider().histogram(MetricOpts(
    "fabric", "soak", "recovery_seconds",
    "Per-churn-event recovery time until fingerprints reconverged",
    ("kind",)))
_EVENTS_TOTAL = default_provider().counter(MetricOpts(
    "fabric", "soak", "events_total",
    "Churn events executed by the soak harness", ("kind",)))
_HEARTBEAT = default_provider().gauge(MetricOpts(
    "fabric", "soak", "heartbeat",
    "Monotonic soak progress beat (events completed so far)", ()))


class SoakError(AssertionError):
    """A violated soak invariant.  The message always embeds the seed
    and the full event schedule (the replay contract) — and, with the
    tracer armed, the flight-recorder tail: the last block timelines
    and events around the failure, so the report says what the system
    was DOING, not just which invariant broke."""

    def __init__(self, msg: str, plan=None):
        if plan is not None:
            msg = f"{msg}\n{plan.describe()}"
        if tracing.armed():
            tracing.auto_dump("soak_error")
            msg = f"{msg}\n{tracing.flight_text()}"
        super().__init__(msg)


class InvariantChecker:
    def __init__(self, world, workload, plan,
                 recovery_window_s: float = 45.0,
                 min_recovery_frac: float = 0.05,
                 thread_baseline=None):
        self.world = world
        self.workload = workload
        self.plan = plan
        self.window_s = recovery_window_s
        self.min_recovery_frac = min_recovery_frac
        self.recovery_by_kind: Dict[str, List[float]] = {}
        self._events_done = 0
        # baseline by OBJECT identity, not name: registered-thread
        # names repeat across instances ("gossip-state-drain" etc.),
        # so a name-set baseline would mask every leaked thread that
        # shares a name with one alive at construction (strong refs,
        # so a recycled id() can never alias a baseline entry).
        # `thread_baseline` is taken before the world is built (the
        # harness does): the world's constructor starts every
        # orderer's Raft workers, which a later baseline would exempt
        self._thread_baseline = (set(thread_baseline)
                                 if thread_baseline is not None
                                 else set(live_registered()))
        # real health: a soak whose heartbeat goes stale (no event
        # completed for 2 recovery windows) flips /healthz so a
        # wedged long run is visible from outside the process
        self._last_beat_wall = time.monotonic()
        default_health().register("soak-heartbeat", self._health_check)

    def _health_check(self) -> None:
        stale = time.monotonic() - self._last_beat_wall
        budget = max(2 * self.window_s, 90.0)
        if stale > budget:
            raise RuntimeError(
                f"soak heartbeat stale: {stale:.0f}s since the last "
                f"completed event (budget {budget:.0f}s)")

    def close_health(self) -> None:
        """Drop the heartbeat checker (harness teardown — a finished
        soak must not leave /healthz reporting staleness forever)."""
        default_health().unregister("soak-heartbeat")

    def beat(self) -> None:
        self._last_beat_wall = time.monotonic()
        _HEARTBEAT.set(float(self._events_done))

    # -- convergence -------------------------------------------------------

    def _stable_tip(self, cid: str, deadline: float) -> int:
        """Wait until the live orderers' stores agree and stop
        growing (in-flight batches flushed by the batch timer)."""
        last, last_t = -1, time.monotonic()
        while time.monotonic() < deadline:
            sups = self.world.supports(cid)
            heights = {s.store.height for s in sups.values()}
            if len(heights) == 1:
                tip = heights.pop()
                if tip != last:
                    last, last_t = tip, time.monotonic()
                elif time.monotonic() - last_t >= 0.4:
                    return tip
            time.sleep(0.05)
        sups = self.world.supports(cid)
        raise SoakError(
            f"orderer tips on {cid} did not stabilize within the "
            f"recovery window: "
            f"{[(o, s.store.height) for o, s in sups.items()]}",
            self.plan)

    def check_converged(self, kind: str,
                        window_s: Optional[float] = None,
                        record: bool = True) -> float:
        """Quiesce traffic, then require every peer at the stable
        orderer tip with a SINGLE state fingerprint per channel,
        within the recovery window.  Returns the recovery time and
        feeds the per-kind histogram.  The window bounds how long the
        checker WAITS for convergence; the returned recovery time can
        exceed it slightly when the straddling settle iteration (its
        own fingerprint computation included) succeeds at the
        boundary — only a deadline passing WITHOUT convergence
        fails.  `record=False` for the
        warmup/final/resubmit convergence checks: they are harness
        phases, not churn events, and must not pollute the
        events_total counter or the per-event-kind recovery report."""
        window = window_s if window_s is not None else self.window_s
        t0 = time.monotonic()
        deadline = t0 + window
        self.workload.pause()
        try:
            for cid in self.world.channel_ids:
                tip = self._stable_tip(cid, deadline)
                # fingerprints are only comparable at IDENTICAL,
                # settled heights: the digest covers the chain height,
                # and a block cut late (a parked raft submit
                # re-injected after the stability window) can put one
                # peer a block ahead of the rest for a moment — that
                # is catch-up, not divergence.  Heights are re-read
                # around the (slow) fingerprint computation so a
                # commit racing the reads voids the sample instead of
                # faking a divergence.
                while True:
                    h0 = [p.height(cid) for p in self.world.peers]
                    settled = (len(set(h0)) == 1 and
                               h0[0] >= self.world.orderer_tip(cid))
                    if settled:
                        fps = {p.name: p.fingerprint(cid)
                               for p in self.world.peers}
                        if h0 == [p.height(cid)
                                  for p in self.world.peers]:
                            if len(set(fps.values())) == 1:
                                break      # converged
                            # identical stable heights, different
                            # digests: the same chain prefix committed
                            # to different state — the REAL divergence
                            raise SoakError(
                                f"after {kind}: state fingerprints "
                                f"DIVERGED on {cid} at height {h0[0]}"
                                f": {fps}", self.plan)
                    if time.monotonic() >= deadline:
                        raise SoakError(
                            f"after {kind}: peers did not converge on "
                            f"{cid} within {window:.1f}s (tip {tip}): "
                            f"heights={[(p.name, p.height(cid)) for p in self.world.peers]}",
                            self.plan)
                    time.sleep(0.05)
        finally:
            self.workload.resume()
        rec = time.monotonic() - t0
        if record:
            self.recovery_by_kind.setdefault(kind, []).append(rec)
            _RECOVERY_HIST.with_labels(kind).observe(rec)
            _EVENTS_TOTAL.with_labels(kind).add(1)
            self._events_done += 1
            self.beat()
        log.info("soak: converged %.2fs after %s", rec, kind)
        return rec

    # -- throughput recovery -----------------------------------------------

    def check_recovery_rate(self, kind: str, pre_rate: float,
                            post_rate: float) -> None:
        if pre_rate <= 0:
            return
        if post_rate < self.min_recovery_frac * pre_rate:
            raise SoakError(
                f"after {kind}: throughput did not recover — "
                f"{post_rate:.2f} tx/s vs pre-event {pre_rate:.2f} "
                f"(floor {self.min_recovery_frac:.2f}x)", self.plan)

    # -- lane health -------------------------------------------------------

    def check_lanes(self) -> None:
        if self.workload.errors:
            raise SoakError(
                f"workload lane failure: {self.workload.errors}",
                self.plan)

    # -- exactly-once ------------------------------------------------------

    def audit_exactly_once(self, resubmit_rounds: int = 3) -> int:
        """Admitted => committed exactly once, per channel, across the
        whole run.  An admitted tx missing at the quiesced tail was
        lost to a leader kill (a broadcast ACK is not a commit — the
        client contract is watch-and-resubmit), so its RETAINED
        envelope is resubmitted and must then commit; any txid
        committing twice fails the run outright.  Returns total
        audited txs."""
        total = 0
        for cid in self.world.channel_ids:
            admitted = set(self.workload.admitted_txids(cid))
            for attempt in range(resubmit_rounds + 1):
                committed = committed_txids(
                    self.world.peers[0].channels[cid].ledger)
                counts = Counter(committed)
                dupes = {t for t, n in counts.items() if n > 1}
                if dupes:
                    raise SoakError(
                        f"txids committed MORE THAN ONCE on {cid}: "
                        f"{sorted(dupes)[:5]}", self.plan)
                missing = admitted - set(committed)
                if not missing:
                    break
                if attempt == resubmit_rounds:
                    raise SoakError(
                        f"{len(missing)} admitted txs never committed "
                        f"on {cid} after {resubmit_rounds} resubmit "
                        f"rounds: {sorted(missing)[:5]}", self.plan)
                log.info("soak: resubmitting %d lost txs on %s",
                         len(missing), cid)
                for txid in sorted(missing):
                    try:
                        self.workload.resubmit(cid, txid)
                    except Exception as e:  # noqa: BLE001
                        log.warning("resubmit %s failed: %s", txid, e)
                self.check_converged(f"resubmit[{cid}]", record=False)
            total += len(admitted)
        return total

    # -- teardown leaks ----------------------------------------------------

    def check_thread_leaks(self, grace_s: float = 5.0) -> None:
        """After world close: no registered worker this run started
        may still be alive (the concurrency subsystem's leak contract
        applied to the whole soak)."""
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            leaked = [t for t in live_registered()
                      if t not in self._thread_baseline]
            if not leaked:
                return
            time.sleep(0.1)
        names = sorted(f"{t.structure}:{t.name}" for t in leaked)
        raise SoakError(
            f"{len(leaked)} worker thread(s) leaked at soak teardown: "
            f"{names}", self.plan)
