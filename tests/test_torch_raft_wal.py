"""The port's Raft WAL (fabric_mod_tpu_torch/orderer/raft.py `RaftWAL`)
against the reference's (fabric_mod_tpu/orderer/raft.py:139).

The same script of writes — hard state, appends with a conflicting
suffix, compaction with a margin, an installed snapshot, a torn final
frame — runs through each package; the files must be byte-equal, and a
file written by either package must replay in the other to the same
terms, hard state, snapshot marker and entries."""
import os

import pytest

from fabric_mod_tpu.orderer import raft as jraft
from fabric_mod_tpu_torch.orderer import raft as traft

PACKAGES = {"reference": jraft.RaftWAL, "port": traft.RaftWAL}


def _state(wal):
    return (wal.term, wal.voted_for, wal.snap_index, wal.snap_term,
            bytes(wal.snap_data), wal.base, wal.base_term,
            [(t, bytes(d)) for t, d in wal.entries], wal.last_index)


def _stage_appends(wal):
    wal.save_hardstate(3, "n1")
    for i in range(1, 11):
        wal.append(i, 1 if i < 6 else 2, b"e%d" % i * i)
    # a new leader's log repair: a conflicting suffix from index 8
    wal.save_hardstate(4, None)
    wal.append(8, 4, b"repaired8")
    wal.append(9, 4, b"")                  # a no-op barrier entry


def _stage_compact(wal):
    wal.compact(7, wal.term_at(7), b"height=7", margin=2)
    for i in range(10, 13):
        wal.append(i, 4, b"after-compact-%d" % i)
    wal.save_hardstate(5, "n2")


def _stage_install(wal):
    wal.install_snapshot(20, 5, b"installed")
    wal.append(21, 5, b"x21")
    wal.append(22, 6, b"x22")


STAGES = {"appends": (_stage_appends,),
          "compact": (_stage_appends, _stage_compact),
          "install": (_stage_appends, _stage_compact, _stage_install)}


def _write(cls, path, stages):
    wal = cls(str(path))
    for stage in stages:
        stage(wal)
    state = _state(wal)
    wal.close()
    return state


@pytest.mark.parametrize("stage", list(STAGES))
def test_same_script_writes_the_same_bytes(tmp_path, stage):
    states = {name: _write(cls, tmp_path / f"{name}.wal", STAGES[stage])
              for name, cls in PACKAGES.items()}
    assert states["port"] == states["reference"]
    assert (tmp_path / "port.wal").read_bytes() == \
        (tmp_path / "reference.wal").read_bytes()


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_either_package_replays_the_others_wal(tmp_path, stage, writer,
                                               reader):
    path = tmp_path / "n.wal"
    written = _write(PACKAGES[writer], path, STAGES[stage])
    replayed = PACKAGES[reader](str(path))
    try:
        assert _state(replayed) == written
        if replayed.last_index > replayed.base:
            assert replayed.term_at(replayed.last_index) == \
                written[7][-1][0]
    finally:
        replayed.close()


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_torn_final_frame_is_cropped_alike(tmp_path, writer, reader):
    """A crash mid-write leaves a torn last frame: the reader crops it
    and truncates the file, and later appends land clean for both."""
    path = tmp_path / "n.wal"
    wal = PACKAGES[writer](str(path))
    _stage_appends(wal)
    before = _state(wal)
    wal.append(10, 4, b"doomed" * 10)
    wal.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)
    good = size - (8 + 1 + 16 + 60)

    replayed = PACKAGES[reader](str(path))
    assert _state(replayed) == before
    assert os.path.getsize(path) == good
    replayed.append(10, 4, b"clean10")
    replayed.close()
    # the writer's package reads the repaired file the same way
    again = {name: cls(str(path)) for name, cls in PACKAGES.items()}
    try:
        states = {name: _state(w) for name, w in again.items()}
        assert states["port"] == states["reference"]
        assert states["port"][7][-1] == (4, b"clean10")
    finally:
        for w in again.values():
            w.close()


@pytest.mark.parametrize("group_commit", [False, True])
def test_fsyncs_counted_as_the_reference(tmp_path, monkeypatch,
                                         group_commit):
    """Without group commit every append is one fsync; with it, appends
    buffer until the barrier; the hard state always syncs.  The
    reference reads its knob, the port takes a constructor argument."""
    if group_commit:
        monkeypatch.setenv("FABRIC_MOD_TPU_WAL_GROUP_COMMIT", "1")
    else:
        monkeypatch.delenv("FABRIC_MOD_TPU_WAL_GROUP_COMMIT", raising=False)
    wals = {"reference": jraft.RaftWAL(str(tmp_path / "r.wal")),
            "port": traft.RaftWAL(str(tmp_path / "p.wal"),
                                  group_commit=group_commit)}
    counts = {}
    for name, wal in wals.items():
        wal.save_hardstate(1, "a")
        for i in range(1, 6):
            wal.append(i, 1, b"d%d" % i)
        mid = wal.sync_count
        wal.sync()
        counts[name] = (mid, wal.sync_count)
        wal.close()
    assert counts["port"] == counts["reference"]
    assert counts["port"] == ((1, 2) if group_commit else (6, 6))
