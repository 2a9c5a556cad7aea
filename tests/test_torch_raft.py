"""The port's RaftNode (fabric_mod_tpu_torch/orderer/raft.py) against the
reference's (fabric_mod_tpu/orderer/raft.py:358).

Three-node clusters of each package run on manual clocks with the same
seeded rngs and are driven by the same script: elect; propose 50; stop
the leader; re-elect; propose 20; restart the old leader over its WAL
and catch it up — by AppendEntries repair, or, with
`snapshot_interval`, by InstallSnapshot.  Proposals go one at a time
(each waited until every live node applied it), so each follower sees
the same messages in the same order, its rng the same draws, and the
election winners are a property of the seeds.  Where a follower can
learn a commit only from a heartbeat (after a catch-up, or behind
pipelined windows), the clock is advanced until it has.  Every node of
both packages must end with the same applied sequence, and each
package must elect the same leaders."""
import json
import random
import time
import zlib

import pytest

from tests._clocksteps import advance_until, settle

from fabric_mod_tpu.orderer import raft as jraft
from fabric_mod_tpu.utils import fakeclock as jclock
from fabric_mod_tpu_torch.orderer import raft as traft
from fabric_mod_tpu_torch.utils import fakeclock as tclock

PACKAGES = {"reference": (jraft, jclock), "port": (traft, tclock)}
IDS = ("n0", "n1", "n2")


def _rng(node_id, salt=""):
    return random.Random(0xE1EC + zlib.crc32((node_id + salt).encode()))


def _one_leader(nodes):
    leaders = [n.id for n in nodes if n.state == "leader"]
    return (len(leaders) == 1
            and all(n.leader_id == leaders[0] for n in nodes))


def _leader(clock, nodes):
    assert advance_until(clock, lambda: _one_leader(nodes)), \
        "no single leader elected"
    return next(n for n in nodes if n.state == "leader")


def _propose(leader, live, applied, data):
    want = len(applied[leader.id]) + 1
    assert leader.propose(data)
    assert settle(lambda: all(len(applied[n.id]) == want for n in live),
                  timeout=10.0), {n.id: len(applied[n.id]) for n in live}


def _drive(pkg, tmp_path, snapshot_interval):
    """The script on one package's cluster; returns (leaders elected,
    applied sequence per node, snapshot installs)."""
    raft, fakeclock = PACKAGES[pkg]
    clock = fakeclock.ManualClock()
    transport = raft.RaftTransport()
    applied = {i: [] for i in IDS}
    installs = []

    def make(i, salt=""):
        def snap_cb():
            return json.dumps([[x, d.decode()] for x, d in applied[i]]
                              ).encode()

        def install_cb(index, data):
            installs.append((i, index))
            applied[i][:] = [(x, d.encode()) for x, d in json.loads(data)]
        return raft.RaftNode(
            i, list(IDS), transport, str(tmp_path / pkg / f"{i}.wal"),
            lambda idx, data: applied[i].append((idx, bytes(data))),
            rng=_rng(i, salt), snapshot_interval=snapshot_interval,
            snapshot_cb=snap_cb if snapshot_interval else None,
            install_cb=install_cb if snapshot_interval else None,
            clock=clock)
    (tmp_path / pkg).mkdir()
    nodes = {i: make(i) for i in IDS}
    for n in nodes.values():
        n.start()
    leaders = []
    try:
        leader = _leader(clock, list(nodes.values()))
        leaders.append(leader.id)
        for k in range(50):
            _propose(leader, list(nodes.values()), applied, b"a%02d" % k)

        # stop the leader; the other two elect a new one
        old = leader.id
        transport.partitioned.add(old)
        nodes[old].stop()
        rest = [n for i, n in nodes.items() if i != old]
        leader = _leader(clock, rest)
        leaders.append(leader.id)
        for k in range(20):
            _propose(leader, rest, applied, b"b%02d" % k)

        # restart the old leader over its WAL (its app state from the
        # WAL's snapshot, as an orderer's block store would hold it)
        revived = make(old, salt="/restarted")
        snap = revived._wal.snap_data
        applied[old] = ([(x, d.encode()) for x, d in json.loads(snap)]
                        if snap else [])
        nodes[old] = revived
        transport.partitioned.discard(old)
        revived.start()
        assert advance_until(
            clock, lambda: applied[old] == applied[leader.id]), \
            (len(applied[old]), len(applied[leader.id]))
        # a follower learns the commit of the last entry from the next
        # append; after a catch-up that may be the next heartbeat
        want = len(applied[leader.id]) + 1
        assert leader.propose(b"after")
        assert advance_until(clock, lambda: all(
            len(applied[i]) == want for i in IDS)), \
            {i: len(applied[i]) for i in IDS}
        leaders.append(leader.id)
    finally:
        for n in nodes.values():
            n.stop()
    return leaders, applied, installs


@pytest.mark.parametrize("snapshot_interval", [None, 8],
                         ids=["repair", "snapshot"])
def test_clusters_apply_the_same_sequence(tmp_path, snapshot_interval):
    runs = {pkg: _drive(pkg, tmp_path, snapshot_interval)
            for pkg in PACKAGES}
    want = ([b"a%02d" % k for k in range(50)]
            + [b"b%02d" % k for k in range(20)] + [b"after"])
    for pkg, (leaders, applied, installs) in runs.items():
        for node_id, seq in applied.items():
            assert [d for _i, d in seq] == want, (pkg, node_id)
        assert len({tuple(seq) for seq in applied.values()}) == 1
        # catch-up by snapshot exactly when the log is compacted
        assert bool(installs) == bool(snapshot_interval), (pkg, installs)
    assert runs["port"][0] == runs["reference"][0]      # the same leaders
    assert runs["port"][1] == runs["reference"][1]      # indices and data
    assert [i for i, _x in runs["port"][2]] == \
        [i for i, _x in runs["reference"][2]]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_frozen_clock_elects_nobody(tmp_path, pkg):
    """Under a manual clock no election happens until time moves."""
    raft, fakeclock = PACKAGES[pkg]
    clock = fakeclock.ManualClock()
    transport = raft.RaftTransport()
    nodes = [raft.RaftNode(i, list(IDS), transport, str(tmp_path / i),
                           lambda idx, data: None, rng=_rng(i), clock=clock)
             for i in IDS]
    for n in nodes:
        n.start()
    try:
        time.sleep(0.3)
        assert all(n.state == "follower" for n in nodes)
        assert _leader(clock, nodes).id == _leader(clock, nodes).id
    finally:
        for n in nodes:
            n.stop()


def test_port_counts_elections_and_wal_syncs(tmp_path):
    """The port's counters: one election won by the leader, one leader
    change seen by each node, an fsync per appended entry and per hard
    state save; with `group_commit`, a propose_many burst is one
    barrier on each node."""
    clock = tclock.ManualClock()
    transport = traft.RaftTransport()
    applied = {i: [] for i in IDS}
    nodes = [traft.RaftNode(i, list(IDS), transport, str(tmp_path / i),
                            lambda idx, data, i=i: applied[i].append(data),
                            rng=_rng(i), clock=clock, group_commit=True,
                            pipeline=2)
             for i in IDS]
    for n in nodes:
        n.start()
    try:
        leader = _leader(clock, nodes)
        assert leader.elections == 1
        assert all(n.leader_changes == 1 for n in nodes)
        syncs = [n.wal_syncs for n in nodes]
        assert leader.propose_many([b"x%d" % k for k in range(100)])
        # pipelined windows: a follower may learn the last commit index
        # only from the next heartbeat
        assert advance_until(clock, lambda: all(len(applied[i]) == 100
                                                for i in IDS))
        assert leader.wal_syncs == syncs[nodes.index(leader)] + 1
        assert all(n.wal_syncs > s for n, s in zip(nodes, syncs))
        assert applied[IDS[0]] == applied[IDS[1]] == applied[IDS[2]]
    finally:
        for n in nodes:
            n.stop()
