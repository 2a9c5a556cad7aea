"""The port's soak in its sharded and relay modes (the reference's
FMT_SOAK_SHARDED and FMT_SOAK_RELAY, here `SoakConfig(sharded=True)`
and `relay=True`), and the soak world's default verifier.

- Sharded (reference tests/test_soak.py:195-213): seed 8, three events
  (a leader kill and config churn among them), every peer's channels
  behind a ChannelShardRouter whose slices are the given verifier (a
  host verifier with the GpuVerifier's async seams; on the card the
  slices are GpuVerifiers, chip_smoke phase 17 (c)); every harness
  invariant armed.
- Relay: the same seed's first four events, blocks down dissemination
  trees; the leader kill also partitions the relay root (the recovery
  recorded as relay_reparent) and the relay must carry blocks.
- `SoakWorld` without a verifier builds one `GpuVerifier` on CUDA,
  shared by every peer and by the orderers' Writers checks: here, with
  no card, it raises; with `device="cpu"` the shared verifier is a CPU
  GpuVerifier.
- The leak sweep's baseline precedes the world: an orderer worker the
  world's constructor started and its close left running is a leak,
  and the harness takes its baseline before it builds the world.
"""
import threading

import pytest

from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.concurrency import RegisteredThread, live_registered
from fabric_mod_tpu_torch.observability.metrics import default_provider
from fabric_mod_tpu_torch.soak import (ChurnPlan, InvariantChecker,
                                       SoakConfig, SoakError, SoakHarness,
                                       SoakWorld)
from fabric_mod_tpu_torch.soak import harness as harness_mod

SEED = 8


class HostSlice(sw.SwVerifier):
    """The host verifier with the async seams a slice verifier offers
    (GpuVerifier's shape): verified at the call, resolved later."""

    def verify_many_async(self, items):
        mask = self.verify_many(items)
        return lambda: mask

    verify_many_fused_async = verify_many_async


def test_soak_sharded_channel_mode():
    cfg = SoakConfig(seed=SEED, n_events=3, n_channels=2, n_peers=2,
                     gap_txs=(3, 5), recovery_window_s=60.0, sharded=True,
                     verifier=HostSlice())
    rep = SoakHarness(cfg).run()
    assert rep["sharded"] is True and rep["relay_mode"] is False
    assert rep["x509_txs"] > 0 and rep["audited_txs"] == rep["x509_txs"]
    assert len(rep["events"]) == 3 and rep["fault_fires"] > 0
    assert [e["kind"] for e in rep["events"]] == [
        "leader_kill", "batch_config", "peer_crash_rejoin"]


def test_soak_relay_mode():
    cfg = SoakConfig(seed=SEED, n_events=4, n_channels=1, n_peers=2,
                     gap_txs=(3, 5), recovery_window_s=60.0, relay=True,
                     verifier=sw.SwVerifier())
    rep = SoakHarness(cfg).run()
    assert rep["relay_mode"] is True
    assert rep["audited_txs"] == rep["x509_txs"] > 0
    assert rep["relay"]["received"] > 0
    assert "relay_reparent" in rep["recovery_s_by_kind"]
    assert "fabric_soak_events_total" in \
        default_provider().render_prometheus()


def test_world_default_verifier_is_one_cuda_gpu_verifier(tmp_path,
                                                        monkeypatch):
    # no card here: the default verifier raises, as e2e.Network's does
    with pytest.raises(RuntimeError, match="CUDA"):
        SoakWorld(str(tmp_path / "none"), SEED, n_channels=1)
    made = []

    class Recording(gpu.GpuVerifier):
        def __init__(self, device=None, **kw):
            made.append(device)
            super().__init__(device=device, **kw)
    monkeypatch.setattr(gpu, "GpuVerifier", Recording)
    with pytest.raises(RuntimeError, match="CUDA"):
        SoakWorld(str(tmp_path / "cuda"), SEED, n_channels=1)
    assert made == [None]
    world = SoakWorld(str(tmp_path / "cpu"), SEED, n_channels=2,
                      device="cpu")
    try:
        assert made == [None, "cpu"]
        assert isinstance(world.verifier, gpu.GpuVerifier)
        assert world.verifier.device.type == "cpu"
        shared = {id(p.channels[cid].verifier) for p in world.peers
                  for cid in world.channel_ids}
        assert shared == {id(world.verifier)}
        # each orderer's Writers check goes through the same verifier
        assert world.orderers and all(
            o.registrar._verify_many == world.verifier.verify_many
            for o in world.orderers.values())
    finally:
        world.close()


def test_leak_sweep_sees_an_orderer_worker_the_world_started(tmp_path):
    baseline = live_registered()
    world = SoakWorld(str(tmp_path), SEED, n_channels=1,
                      verifier=sw.SwVerifier())
    chain = world.orderers["o0"].registrar.get_chain("soak0").chain
    # a chain whose halt does nothing: its Raft workers outlive close()
    chain.halt = lambda: None
    plan = ChurnPlan(SEED, 1)
    try:
        # a baseline taken after the world exempts them (the old order)
        late = InvariantChecker(world, None, plan)
        late.close_health()
        world.close()
        late.check_thread_leaks(grace_s=0.5)
        checker = InvariantChecker(world, None, plan,
                                   thread_baseline=baseline)
        checker.close_health()
        with pytest.raises(SoakError) as ei:
            checker.check_thread_leaks(grace_s=0.5)
        assert "orderer.raftchain:raftchain[o0]" in str(ei.value)
        assert "orderer.raft:raft-fsm[o0]" in str(ei.value)
    finally:
        type(chain).halt(chain)
    checker.check_thread_leaks(grace_s=5.0)


def test_harness_takes_the_leak_baseline_before_the_world(monkeypatch):
    stop = threading.Event()
    started, seen = [], {}

    class Sentinel(Exception):
        pass

    def world(*args, **kw):
        t = RegisteredThread(target=stop.wait, name="raftchain[o0]",
                             structure="orderer.raftchain")
        t.start()
        started.append(t)
        return object()

    def checker(*args, thread_baseline=None, **kw):
        seen["baseline"] = thread_baseline
        raise Sentinel
    monkeypatch.setattr(harness_mod, "SoakWorld", world)
    monkeypatch.setattr(harness_mod, "MixedWorkload", lambda *a, **k: None)
    monkeypatch.setattr(harness_mod, "InvariantChecker", checker)
    try:
        with pytest.raises(Sentinel):
            SoakHarness(SoakConfig(seed=SEED, n_events=1,
                                   verifier=sw.SwVerifier())).run()
    finally:
        stop.set()
        for t in started:
            t.join(timeout=5)
    assert len(started) == 1
    assert started[0] not in set(seen["baseline"])
