"""The port's soak planning and invariants (fabric_mod_tpu_torch/soak/
plan.py, invariants.py, harness.py's config), against the reference.

- `ChurnPlan(seed, n_events)` gives the reference's JSON bit for bit
  for seeds 0-31 and n_events 1-9, restricted kind pools and custom gap
  ranges included; `EVENT_KINDS` and `CORE_KINDS` equal the
  reference's.
- No seed schedules a kill, removal, restart or partition past Raft
  quorum (the reference's tests/test_soak.py:48 sweep, here over the
  port's plans).
- `SoakConfig` keeps the reference's knob defaults as arguments, and a
  harness regenerates the same schedule from the config alone.
- A violated invariant fails loudly with the seed and the schedule
  (reference tests/test_soak.py:116), and the checker's heartbeat
  flips the port's /healthz when stale.
"""
import json

import pytest
from fabric_mod_tpu.soak import plan as jplan

from fabric_mod_tpu_torch.observability.opsserver import default_health
from fabric_mod_tpu_torch.soak import (CORE_KINDS, EVENT_KINDS, ChurnEvent,
                                       ChurnPlan, InvariantChecker,
                                       SoakConfig, SoakError, SoakHarness)


def test_kind_catalogs_equal_the_references():
    assert EVENT_KINDS == jplan.EVENT_KINDS
    assert CORE_KINDS == jplan.CORE_KINDS
    with pytest.raises(ValueError):
        ChurnEvent("not_a_kind", 3)


@pytest.mark.parametrize("seed", range(32))
def test_plan_equals_the_references(seed):
    for n in range(1, 10):
        mine, ref = ChurnPlan(seed, n), jplan.ChurnPlan(seed, n)
        assert mine.to_json() == ref.to_json(), (seed, n)
        assert mine.kinds() == ref.kinds()
    crash = ("peer_crash_rejoin", "orderer_restart", "network_partition")
    for kinds in (crash, tuple(k for k in CORE_KINDS if k not in crash),
                  ("leader_kill", "consenter_remove")):
        assert ChurnPlan(seed, 6, kinds=kinds).to_json() == \
            jplan.ChurnPlan(seed, 6, kinds=kinds).to_json()
    assert ChurnPlan(seed, 9, gap_txs=(3, 5)).to_json() == \
        jplan.ChurnPlan(seed, 9, gap_txs=(3, 5)).to_json()


def test_default_seed_covers_every_kind_and_is_pure():
    a, b = ChurnPlan(8, 9), ChurnPlan(8, 9)
    assert a == b and a.events == b.events
    assert set(a.kinds()) == set(CORE_KINDS)
    assert ChurnPlan(8, 9).to_json() != ChurnPlan(9, 9).to_json()
    assert json.loads(a.to_json())["seed"] == 8


def test_plan_never_schedules_quorum_suicide():
    for seed in range(50):
        members, live = 3, 3
        for ev in ChurnPlan(seed, 10).events:
            if ev.kind in ("orderer_restart", "network_partition"):
                assert live - 1 >= members // 2 + 1, \
                    (seed, ev.kind, members, live)
                continue
            if ev.kind == "leader_kill":
                live -= 1
            elif ev.kind == "consenter_add":
                members += 1
                live += 1
            elif ev.kind == "consenter_remove":
                dead = members - live
                members -= 1
                if dead == 0:
                    live -= 1
            assert live >= members // 2 + 1, (seed, ev.kind, members, live)


def test_config_defaults_are_the_reference_knobs():
    cfg = SoakConfig()
    assert (cfg.seed, cfg.n_events, cfg.n_channels, cfg.n_peers,
            cfg.gap_txs, cfg.recovery_window_s, cfg.min_recovery_frac,
            cfg.x509_gap_s, cfg.idemix_gap_s, cfg.fault_p, cfg.kinds,
            cfg.partition_s, cfg.crash_hold_s, cfg.sharded,
            cfg.relay) == (8, 6, 2, 2, (4, 9), 45.0, 0.05, 0.12, 1.0,
                           0.05, None, 2.0, 1.0, False, False)
    assert cfg.verifier is None and cfg.device is None
    assert set(SoakConfig(no_crash=True).kinds) == set(CORE_KINDS) - {
        "peer_crash_rejoin", "orderer_restart", "network_partition"}
    h = SoakHarness(SoakConfig(seed=8, n_events=9))
    assert h.plan.to_json() == SoakHarness(
        SoakConfig(seed=8, n_events=9)).plan.to_json() == \
        jplan.ChurnPlan(8, 9).to_json()


class _StubLedgerWorld:
    """One channel, two peers whose fingerprints disagree at the stable
    tip."""

    class _Sup:
        class store:
            height = 3

    class _Peer:
        def __init__(self, name, fp):
            self.name, self._fp = name, fp

        def height(self, cid):
            return 3

        def fingerprint(self, cid):
            return self._fp

    def __init__(self):
        self.channel_ids = ["c0"]
        self.peers = [self._Peer("p0", "aa"), self._Peer("p1", "bb")]

    def supports(self, cid, voting_only=True):
        return {"o0": self._Sup()}

    def orderer_tip(self, cid):
        return 3


class _StubWorkload:
    errors = []

    def pause(self, timeout_s=30.0):
        pass

    def resume(self):
        pass


def test_divergence_fails_loudly_with_seed_and_schedule():
    plan = ChurnPlan(42, 5)
    checker = InvariantChecker(_StubLedgerWorld(), _StubWorkload(), plan,
                               recovery_window_s=3.0)
    try:
        with pytest.raises(SoakError) as ei:
            checker.check_converged("leader_kill")
    finally:
        checker.close_health()
    msg = str(ei.value)
    assert "DIVERGED" in msg
    assert "seed=42" in msg                   # the replay command
    assert plan.to_json() in msg              # the exact schedule


def test_stale_heartbeat_flips_health_and_close_drops_it():
    checker = InvariantChecker(_StubLedgerWorld(), _StubWorkload(),
                               ChurnPlan(1, 1), recovery_window_s=1.0)
    try:
        assert "soak-heartbeat" not in default_health().status()[1]
        checker._last_beat_wall -= 1000.0
        status, failed = default_health().status()
        assert status != "OK" and "heartbeat stale" in failed[
            "soak-heartbeat"]
        checker.beat()
        assert "soak-heartbeat" not in default_health().status()[1]
        # lane failures surface as SoakError with the schedule
        wl = _StubWorkload()
        wl.errors = ["idemix lane died"]
        checker.workload = wl
        with pytest.raises(SoakError, match="idemix lane died"):
            checker.check_lanes()
        with pytest.raises(SoakError, match="did not recover"):
            checker.check_recovery_rate("leader_kill", 10.0, 0.1)
        checker.check_recovery_rate("leader_kill", 10.0, 1.0)
    finally:
        checker.close_health()
    assert "soak-heartbeat" not in default_health().status()[1]
