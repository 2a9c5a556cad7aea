"""Channel sharding, port against reference: the port's ShardMap,
CrossChannelVerifyService, ChannelShardRouter and multihost spec
(fabric_mod_tpu_torch/sharding/) against the JAX package's.

* ShardMap: the same join/leave sequences (fixed, and generated by
  hypothesis from seeds) give the reference's placements, loads and move
  plans.
* The shared service: tagged items route to their slice's verifier,
  untagged and unknown tags to the default slice, and a slice verifier
  that raises fails only its own group's futures in a flush window the
  other slice shares.
* The router: 3 channels x 3 blocks x 3 txs through 2 slices of the
  host verifier, blocks submitted round robin, give per-channel txflags
  and state fingerprints equal to the reference router's
  (FakeBatchVerifier(SwCSP()) slices) on the same encoded blocks and to
  independent unsharded runs (test_torch_sharding_device.py runs the
  same with `GpuVerifier(device="cpu")` slices); a poisoned pipe, a
  tampered channel, rebalance on leave, unplaced or closed use and a
  peer.Channel bound to the router behave as in the reference.

The world comes from tests/_torch_sharding_world.py; the streams from
the port's fixtures.make_channel_stream, whose output the reference
commits to the same flags and state as its own generator's.
"""
import threading

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fabric_mod_tpu.protos import messages as jm
from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.sharding import (ChannelShardRouter,
                                           CrossChannelVerifyService,
                                           ShardMap, multihost_spec)
from fabric_mod_tpu_torch.sharding.multihost import initialize_multihost
from fabric_mod_tpu_torch.utils import fixtures
from tests import _torch_sharding_world as W

V = m.TxValidationCode


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU verify is thousands of small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------------------
# ShardMap: placement as a pure function of the join/leave sequence
# --------------------------------------------------------------------------

def _replay(mp, ops):
    """Apply ("join"|"leave", channel) ops to the map `mp`; every return
    value, then the final loads and placement."""
    out = []
    for op, cid in ops:
        out.append(mp.assign(cid) if op == "join" else mp.release(cid))
    placed = {cid: mp.slice_of(cid) for _, cid in ops if cid in mp}
    return out, mp.loads(), placed, [mp.channels(i)
                                     for i in range(mp.n_slices)]


def _equal_reference(n_slices, ops):
    """The port's map (which always rebalances on leave) against the
    reference's with rebalancing on."""
    from fabric_mod_tpu.sharding import ShardMap as RefShardMap
    return _replay(ShardMap(n_slices), ops) == \
        _replay(RefShardMap(n_slices, rebalance=True), ops)


FIXED = [
    (3, [("join", f"ch{i}") for i in range(7)] + [("join", "ch1")]),
    (2, [("join", f"ch{i}") for i in range(4)]
     + [("leave", "ch0"), ("leave", "ch2")]),
    (3, [("join", f"ch{i}") for i in range(6)]
     + [("leave", "ch0"), ("leave", "ch3"), ("leave", "ghost")]),
    (4, [("join", f"c{i}") for i in range(9)]
     + [("leave", f"c{i}") for i in (0, 4, 8, 1, 5)]
     + [("join", "n0"), ("join", "n1")]),
]


@pytest.mark.parametrize("n_slices, ops", FIXED)
def test_shardmap_fixed_sequences_equal_reference(n_slices, ops):
    assert _equal_reference(n_slices, ops)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(n_slices=st.integers(1, 5),
       ops=st.lists(st.tuples(st.sampled_from(["join", "join", "leave"]),
                              st.integers(0, 11).map(lambda i: f"ch{i}")),
                    max_size=40))
def test_shardmap_generated_sequences_equal_reference(n_slices, ops):
    assert _equal_reference(n_slices, ops)


def test_shardmap_unknown_channels_and_bad_sizes():
    mp = ShardMap(2)
    with pytest.raises(KeyError):
        mp.slice_of("ghost")
    assert mp.slice_of("ghost", default=0) == 0
    with pytest.raises(ValueError):
        ShardMap(0)


# --------------------------------------------------------------------------
# CrossChannelVerifyService: one flusher, per-slice groups, isolation
# --------------------------------------------------------------------------

class _Recording(sw.SwVerifier):
    """The host verifier, recording each call's items."""

    def __init__(self):
        self.calls = []

    def verify_many(self, items):
        self.calls.append(list(items))
        return super().verify_many(items)


class _Raising:
    def verify_many_async(self, items):
        raise RuntimeError("slice verifier down")


def _service(verifiers, deadline_s=0.005):
    mp = ShardMap(len(verifiers))
    svc = CrossChannelVerifyService(
        dict(enumerate(verifiers)), lambda tag: mp.slice_of(tag, default=0),
        deadline_s=deadline_s)
    return svc, mp


def test_tagged_items_route_per_slice_and_verdicts_come_back():
    recs = [_Recording(), _Recording()]
    svc, mp = _service(recs)
    mp.assign("big")                           # slice 0
    mp.assign("small")                         # slice 1
    items, expect = fixtures.make_verify_items(6, invalid_every=3)
    try:
        futs = ([svc.submit(it, tag="big") for it in items[:3]]
                + [svc.submit(it, tag="small") for it in items[3:]])
        assert [f.result(timeout=60) for f in futs] == expect
        assert svc.verify_many_for("small", items, timeout=60) == expect
    finally:
        svc.close()
    seen = [{it.digest for call in r.calls for it in call} for r in recs]
    assert seen[0] == {it.digest for it in items[:3]}
    assert seen[1] == {it.digest for it in items}
    assert svc.flushes >= 2 and svc.groups[1] >= 2


def test_untagged_and_unknown_tags_ride_the_default_slice():
    recs = [_Recording(), _Recording()]
    svc, mp = _service(recs)
    mp.assign("a")
    mp.assign("b")                             # slice 1 is taken
    items, expect = fixtures.make_verify_items(4, invalid_every=2)
    try:
        assert svc.verify_many(items, timeout=60) == expect
        assert svc.verify_many_for("never-placed", items,
                                   timeout=60) == expect
    finally:
        svc.close()
    assert len(recs[0].calls) >= 1 and recs[1].calls == []


def test_a_raising_slice_fails_only_its_own_group():
    """Both channels' items land in ONE flush window (a 0.3 s deadline
    and max_batch above their sum): the raising slice's futures carry its
    error, the other slice's riders resolve."""
    healthy = _Recording()
    svc, mp = _service([_Raising(), healthy], deadline_s=0.3)
    mp.assign("victim")                        # slice 0
    mp.assign("bystander")                     # slice 1
    items, expect = fixtures.make_verify_items(4, invalid_every=2)
    try:
        vf = [svc.submit(it, tag="victim") for it in items]
        bf = [svc.submit(it, tag="bystander") for it in items]
        assert [f.result(timeout=60) for f in bf] == expect
        for f in vf:
            with pytest.raises(RuntimeError, match="slice verifier down"):
                f.result(timeout=60)
        assert svc.flushes == 1 and svc.groups == {0: 1, 1: 1}
    finally:
        svc.close()


def test_service_rejects_bad_slices():
    with pytest.raises(ValueError):
        CrossChannelVerifyService({}, lambda tag: 0)
    with pytest.raises(ValueError):
        CrossChannelVerifyService({1: sw.SwVerifier()}, lambda tag: 1)


# --------------------------------------------------------------------------
# The router: the block-path differentials
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    return W.make_world()


@pytest.fixture(scope="module")
def streams(world):
    return W.make_streams(world[0])


@pytest.fixture(scope="module")
def baseline(world, streams):
    return W.make_baseline(world[0], streams)


def _host_router(n_slices=2, depth=2):
    return ChannelShardRouter(n_slices=n_slices, depth=depth,
                              verifier_factory=lambda i, mesh: W.HostSlice())


def test_channel_stream_generators_agree(world, tmp_path):
    """The port's and the reference's make_channel_stream, from signers
    over the same keys, commit (in the reference) to the same flags and
    the same state."""
    from fabric_mod_tpu.bccsp.tpu import FakeBatchVerifier
    from fabric_mod_tpu.peer import Committer as RefCommitter
    from fabric_mod_tpu.utils.fixtures import \
        make_channel_stream as ref_stream
    port_world, ref = world
    out = []
    for k, raws in enumerate((
            fixtures.make_channel_stream(port_world.signers, "gen", 2, 4),
            ref_stream(ref.signers, "gen", 2, 4))):
        t = ref.target("gen", FakeBatchVerifier(ref.csp), tmp_path / f"g{k}")
        c = RefCommitter(t.validator, t.ledger)
        flags = [list(c.store_block(jm.Block.decode(raw))) for raw in raws]
        out.append((flags, t.ledger.state_fingerprint()))
        t.ledger.close()
    assert out[0] == out[1]
    assert {f for blk in out[0][0] for f in blk} == \
        {V.VALID, V.ENDORSEMENT_POLICY_FAILURE}


def test_sharded_run_equals_reference_router_and_independent_runs(
        world, streams, baseline, tmp_path):
    """THE acceptance differential on host-verifier slices (the device
    verifier's run: test_torch_sharding_device.py)."""
    port_world, ref = world
    reference = W.reference_router_run(ref, streams, tmp_path)
    got = W.sharded_run(port_world, streams, lambda i, mesh: W.HostSlice())
    W.check_sharded(got, reference, baseline)


def test_poisoned_channel_pipe_never_wedges_the_rest(world, streams,
                                                     baseline):
    """Channel A's pipe is poisoned on its first block; B commits its
    whole stream through the same router, the shared service answers
    riders of both, and A's next store_block rebuilds a pipe from the
    committed height and recovers, equal to its baseline."""
    port_world, _ = world
    router = _host_router()
    boom = {"armed": False}

    class CrashingTarget:
        def __init__(self, inner):
            self._inner = inner
            self.validator = inner.validator
            self.ledger = inner.ledger

        def stage_block(self, block):
            return self._inner.stage_block(block)

        def commit_staged(self, staged):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected commit crash")
            return self._inner.commit_staged(staged)

    try:
        ta = CrashingTarget(W.target(port_world, "ch0",
                                    router.add_channel("ch0")))
        router.bind_target("ch0", ta)
        tb = W.target(port_world, "ch1", router.add_channel("ch1"))
        router.bind_target("ch1", tb)
        boom["armed"] = True
        pipe = router.pipeline_for("ch0")
        pipe.submit(m.Block.decode(streams["ch0"][0]))
        with pytest.raises(RuntimeError, match="injected commit crash"):
            pipe.flush(timeout_s=60)
        assert router.pipeline_for("ch0") is not pipe       # rebuilt
        for raw in streams["ch1"]:
            router.store_block("ch1", m.Block.decode(raw))
        assert tb.ledger.state_fingerprint() == baseline["ch1"][1]
        items, expect = fixtures.make_verify_items(4, invalid_every=2)
        for cid in ("ch1", "ch0"):
            assert router.service.verify_many_for(cid, items,
                                                  timeout=60) == expect
        for raw in streams["ch0"]:
            router.store_block("ch0", m.Block.decode(raw))
        assert (W.flags(ta.ledger), ta.ledger.state_fingerprint()) == \
            baseline["ch0"][:2]
    finally:
        router.close()


def test_tampered_channel_batch_never_perturbs_the_other(world, streams,
                                                         baseline):
    """A's block with every envelope signature zeroed validates
    concurrently with B's clean stream: A's txs are all flagged invalid,
    B's flags and fingerprint equal its baseline."""
    port_world, _ = world
    router = _host_router()
    try:
        ta = W.target(port_world, "ch0", router.add_channel("ch0"))
        router.bind_target("ch0", ta)
        tb = W.target(port_world, "ch1", router.add_channel("ch1"))
        router.bind_target("ch1", tb)
        blk_a = m.Block.decode(streams["ch0"][0])
        for i, raw_env in enumerate(blk_a.data.data):
            env = m.Envelope.decode(raw_env)
            env.signature = bytes(len(env.signature))
            blk_a.data.data[i] = env.encode()
        a_flags = []
        t = threading.Thread(
            target=lambda: a_flags.append(router.store_block("ch0", blk_a)),
            daemon=True)
        t.start()
        for raw in streams["ch1"]:
            router.store_block("ch1", m.Block.decode(raw))
        t.join(timeout=120)
        assert not t.is_alive()
        assert a_flags and all(f != V.VALID for f in a_flags[0])
        assert (W.flags(tb.ledger), tb.ledger.state_fingerprint()) == \
            baseline["ch1"][:2]
    finally:
        router.close()


def test_rebalance_on_leave_moves_and_rebuilds_pipes(world, streams):
    """Four channels on two slices: a spread-1 leave moves nothing;
    stranding slice 0 moves slice 1's newest channel (chX) over, its old
    pipe drained and closed, the next one built for slice 0, and the
    channel keeps committing in order."""
    port_world, _ = world
    router = _host_router(depth=1)
    try:
        tgts = {}
        for cid in ("ch0", "ch1", "ch2", "chX"):
            tgts[cid] = W.target(port_world, cid, router.add_channel(cid))
            router.bind_target(cid, tgts[cid])
        assert router.map.loads() == [2, 2]
        router.store_block("chX", m.Block.decode(streams["ch1"][0]))
        p1 = router.pipeline_for("chX")
        assert router.slice_of("chX") == 1
        assert router.remove_channel("ch0") == []
        assert router.remove_channel("ch2") == [("chX", 1, 0)]
        assert router.slice_of("chX") == 0 and p1.closed
        handle = tgts["chX"].validator._verifier
        assert handle.slice_index == 0
        assert router.slice_verifier("chX") is router.verifiers[0]
        router.store_block("chX", m.Block.decode(streams["ch1"][1]))
        assert router.pipeline_for("chX") is not p1
        assert tgts["chX"].ledger.height == 2
    finally:
        router.close()


def test_router_rejects_unplaced_and_closed_use():
    router = _host_router(n_slices=1)
    with pytest.raises(KeyError):
        router.pipeline_for("nope")
    router.add_channel("t")                    # no target bound
    with pytest.raises(RuntimeError):
        router.pipeline_for("t")
    with pytest.raises(ValueError):
        ChannelShardRouter(n_slices=2, meshes=[("cpu",)],
                           verifier_factory=lambda i, mesh: W.HostSlice())
    router.close()
    with pytest.raises(RuntimeError):
        router.add_channel("late")
    with pytest.raises(RuntimeError):
        router.service.verify_many_for("t", fixtures.make_verify_items(1)[0])
    router.close()                             # idempotent


def test_channel_delegates_its_pipe_to_the_router(tmp_path):
    """peer.Channel.use_shard_router: a pipe the channel built first is
    drained, then store_block commits through the router's pipe."""
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.peer.channel import Channel
    material = fixtures.make_network_material(3, max_message_count=4,
                                              batch_timeout="60s")
    genesis = m.Block.decode(material.genesis)
    cid, config = config_from_block(genesis)
    router = _host_router(n_slices=1)
    try:
        handle = router.add_channel(cid)
        channel = Channel(cid, KvLedger(cid), handle,
                          Bundle(cid, config, sw.SwCSP()), sw.SwCSP(),
                          pipeline_depth=1)
        channel.init_from_genesis(genesis)
        own = channel.commit_pipeline()
        channel.use_shard_router(router)
        assert own.closed
        assert channel.commit_pipeline() is router.pipeline_for(cid)
        assert channel.verifier.slice_index == 0
    finally:
        router.close()


# --------------------------------------------------------------------------
# Multi-host spec: shape pinned, bring-up stubbed
# --------------------------------------------------------------------------

SPEC_KEYS = ("hosts", "slices", "slices_per_host", "process_groups")


@pytest.mark.parametrize("hosts, slices", [(1, 1), (1, 4), (2, 8), (4, 8),
                                           (3, 9), (3, 8), (2, 3)])
def test_multihost_spec_equals_reference(hosts, slices):
    from fabric_mod_tpu.sharding import multihost_spec as ref_spec
    try:
        want = ref_spec(n_hosts=hosts, n_slices=slices)
    except ValueError:
        with pytest.raises(ValueError):
            multihost_spec(n_hosts=hosts, n_slices=slices)
        return
    got = multihost_spec(n_hosts=hosts, n_slices=slices)
    assert {k: got[k] for k in SPEC_KEYS} == {k: want[k] for k in SPEC_KEYS}
    flat = sorted(s for g in got["process_groups"] for s in g["slices"])
    assert flat == list(range(slices))


def test_multihost_initialize_is_a_stub_above_one_host():
    initialize_multihost()
    initialize_multihost(1)
    with pytest.raises(NotImplementedError):
        initialize_multihost(2)
