"""The port's fault seams on the CPU device: what chip_smoke phase 17 (b)
holds on the card, here with the plain verify path.

- `bccsp.device.dispatch` and `bccsp.device.resolve` armed once under a
  BatchingVerifyService over `GpuVerifier(device="cpu")`: every waiter
  of that batch gets the InjectedFault and no verdict (the port has no
  software failover: a device fault raises for every kind), and the
  service keeps serving: the next batch's verdicts equal the
  construction's and the host oracle's.
- `commitpipe.commit` and `commitpipe.stage` armed on their second pass
  while a Channel with a depth-2 pipe on the CPU device commits an
  ordered stream: the poisoned pipe is rebuilt once, the block retried
  through it, and the fingerprint equals the stream's first commit.
- `peer.ledger.crash`: the commit dies with the block durable in the
  block store and none of its state; a reopen replays exactly that
  block, to the fingerprint of a ledger that never crashed.

One torch thread: the plain path costs seconds a call and more threads
only slow it here.
"""
import os
import tempfile

import pytest
import torch

from fabric_mod_tpu_torch import e2e, faults
from fabric_mod_tpu_torch.bccsp import gpu, sw
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

N = 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("point", ["bccsp.device.dispatch",
                                   "bccsp.device.resolve"])
def test_device_fault_reaches_every_waiter_and_the_next_batch_holds(point):
    items, expect = fixtures.make_block(1, n_tx=40)
    # lanes 96..103 hold six planted false ones
    first, second = items[:N], items[96:96 + N]
    want = [bool(x) for x in expect[96:96 + N]]
    assert not all(want)
    assert list(sw.SwVerifier().verify_many(second)) == want
    svc = gpu.BatchingVerifyService(
        gpu.GpuVerifier(device="cpu", cache_size=0, buckets=(N,)),
        max_batch=N, deadline_s=5.0)
    plan = faults.FaultPlan().add(point, nth=1)
    try:
        with faults.active(plan):
            futs = [svc.submit(it) for it in first]
            errs = [f.exception(timeout=120) for f in futs]
            assert all(isinstance(e, faults.InjectedFault) for e in errs)
            assert all(e.point == point for e in errs)
            futs = [svc.submit(it) for it in second]
            got = [f.result(timeout=120) for f in futs]
    finally:
        svc.close()
    assert got == want
    assert plan.fires(point) == 1 and plan.calls(point) == 2


@pytest.fixture(scope="module")
def ordered():
    """Two 8-tx blocks ordered and committed by a host-verifier Network:
    (material, encoded blocks, their flags, the fingerprint)."""
    mat = fixtures.make_network_material(31, max_message_count=8,
                                         batch_timeout="60s")
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=mat, verifier=sw.SwVerifier())
        try:
            submits, _want = fixtures.make_e2e_stream(net, 16, plant_every=8)
            for env, ok in submits:
                if ok:
                    net.broadcast.submit(env)
            assert e2e.commit_until(net, 16, 300)[1] == 16
            blocks = [net.support.store.get_block_by_number(b).encode()
                      for b in (1, 2)]
            flags = [list(protoutil.block_txflags(
                net.ledger.get_block_by_number(b))) for b in (1, 2)]
            fp = net.ledger.state_fingerprint()
        finally:
            net.close()
    return mat, blocks, flags, fp


@pytest.mark.parametrize("point", ["commitpipe.commit", "commitpipe.stage"])
def test_poisoned_pipe_is_rebuilt_once_on_the_device_path(ordered, point):
    mat, blocks, flags, fp = ordered
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=mat,
                          verifier=gpu.GpuVerifier(device="cpu",
                                                   buckets=(32,)),
                          tensor_policy=True, pipeline_depth=2)
        try:
            pipes, got = [], []
            plan = faults.FaultPlan().add(point, nth=2)
            with faults.active(plan):
                for raw in blocks:
                    pipes.append(net.channel.commit_pipeline())
                    got.append(list(net.channel.store_block(
                        m.Block.decode(raw))))
                pipes.append(net.channel.commit_pipeline())
            assert plan.fires(point) == 1
            assert len({id(p) for p in pipes}) == 2      # rebuilt once
            assert got == flags
            assert net.ledger.height == 3
            assert net.ledger.state_fingerprint() == fp
        finally:
            net.close()


def test_ledger_crash_seam_replays_the_block_on_reopen(tmp_path):
    w = fixtures.make_commit_world()
    blocks, expected = fixtures.make_commit_blocks(w, 2, 8)
    clean = w.committer(sw.SwVerifier())
    for raw in blocks:
        clean.store_block(m.Block.decode(raw))
    cid = w.channel_id
    path = str(tmp_path / "crashed")
    led = KvLedger(cid, ledger_dir=path)
    c = w.committer(sw.SwVerifier(), ledger=led)
    assert c.store_block(m.Block.decode(blocks[0])) == expected[0]
    plan = faults.FaultPlan().add("peer.ledger.crash", nth=1)
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            c.store_block(m.Block.decode(blocks[1]))
    assert led.blockstore.height == 2 and plan.fires() == 1
    # abandoned, not closed: the reopen finds the state one block behind
    reopened = KvLedger(cid, ledger_dir=path)
    try:
        assert reopened.replayed_blocks == 1
        assert reopened.height == clean.ledger.height == 2
        assert reopened.state_fingerprint() == \
            clean.ledger.state_fingerprint() == \
            reopened.state_fingerprint_full()
    finally:
        reopened.close()
    assert os.path.isdir(path)


def test_snapshot_joined_peer_delivers_from_its_base(ordered, tmp_path):
    """The soak's snapshot join: a peer bootstrapped from a snapshot
    holds no block below its base, so its deliver client takes the
    previous hash from the block store's base marker (the reference's
    client reads block height-1 and fails on such a ledger)."""
    from fabric_mod_tpu_torch.channelconfig import Bundle, config_from_block
    from fabric_mod_tpu_torch.ledger.kvledger import LedgerManager
    from fabric_mod_tpu_torch.ledger.snapshot import bootstrap_from_snapshot
    from fabric_mod_tpu_torch.peer.channel import Channel
    from fabric_mod_tpu_torch.peer.deliverclient import DeliverClient
    mat, blocks, flags, fp = ordered
    with tempfile.TemporaryDirectory() as root:
        net = e2e.Network(root, material=mat, verifier=sw.SwVerifier())
        try:
            # the source peer commits block 1 only, then snapshots
            net.channel.store_block(m.Block.decode(blocks[0]))
            net.ledger.snapshot_to(str(tmp_path / "snap"))
            cid, config = config_from_block(m.Block.decode(mat.genesis))
            joined = bootstrap_from_snapshot(str(tmp_path / "snap"),
                                             str(tmp_path / "joined" / cid))
            joined.close()
            mgr = LedgerManager(str(tmp_path / "joined"))
            try:
                ledger = mgr.create_or_open(cid)
                assert ledger.height == 2
                assert ledger.get_block_by_number(1) is None
                channel = Channel(cid, ledger, sw.SwVerifier(),
                                  Bundle(cid, config, sw.SwCSP()), sw.SwCSP())

                class Source:
                    def blocks(self, start, stop_event=None, timeout_s=1.0):
                        assert start == 2
                        yield m.Block.decode(blocks[1])
                client = DeliverClient(channel, Source())
                client.run(idle_timeout_s=1.0)
                assert ledger.height == 3
                assert list(protoutil.block_txflags(
                    ledger.get_block_by_number(2))) == flags[1]
                assert ledger.state_fingerprint() == fp
            finally:
                mgr.close()
        finally:
            net.close()
