"""The port's durable KvLedger against the reference's: the same blocks
committed with the same flags into a durable ledger of each package give
equal flags, state fingerprints (incremental == full scan) and key
histories; the crash window (the block in the block store, none of its
effects) replays exactly one block on reopen; a clean reopen replays
none; a ledger directory opens in the other package with the same
fingerprint, both ways; the durable=False ledger's snapshot bounds its
replay.  Mirrors tests/test_crash_recovery.py:40-95 and
tests/test_ledger.py:248,307.  The blocks are the port's seeded commit
fixture and its state-scale stream; no verify runs here but the host
verifier of the state-scale arms."""
import pytest

from fabric_mod_tpu.ledger.kvledger import KvLedger as JKvLedger
from fabric_mod_tpu.protos import messages as jm

from fabric_mod_tpu_torch.bccsp import sw
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger, LedgerManager
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil
from fabric_mod_tpu_torch.utils import fixtures

NS = fixtures.NAMESPACE


@pytest.fixture(scope="module")
def stream():
    world = fixtures.make_commit_world()
    return world, fixtures.make_commit_blocks(world, 4, 16)


def _histories(led, keys):
    return [led.history.get_history_for_key(NS, k) for k in keys]


def _keys(led):
    return sorted(k for ns, k, _v, _ver in led.state.iter_state()
                  if ns == NS) + ["absent"]


def test_durable_commit_equals_reference(stream, tmp_path):
    _world, (blocks, expected) = stream
    led = KvLedger("ch", str(tmp_path / "p"))
    jled = JKvLedger(str(tmp_path / "r"), "ch", durable=True)
    assert led.durable
    for raw, flags in zip(blocks, expected):
        assert led.commit_block(m.Block.decode(raw), flags) == \
            jled.commit_block(jm.Block.decode(raw), flags) == flags
        assert led.state_fingerprint() == jled.state_fingerprint() == \
            led.state_fingerprint_full()
    keys = _keys(led)
    assert _histories(led, keys) == [
        jled.history.get_history_for_key(NS, k) for k in keys]
    assert led.history.get_history_for_key(NS, "counter") == [(0, 1)]
    assert led.state.batch_writes == len(blocks)
    led.close()
    jled.close()


def test_crash_window_replays_exactly_one_block(stream, tmp_path):
    _world, (blocks, expected) = stream
    clean = KvLedger("ch", str(tmp_path / "clean"))
    crashed = KvLedger("ch", str(tmp_path / "crash"))
    for raw, flags in zip(blocks, expected):
        clean.commit_block(m.Block.decode(raw), flags)
    for raw, flags in zip(blocks[:-1], expected[:-1]):
        crashed.commit_block(m.Block.decode(raw), flags)
    crashed.state_fingerprint()            # seed the fold before the crash
    # the reference's crash seam (kvledger.py:452-457): the block is
    # durable in the block store, none of its effects are
    last = m.Block.decode(blocks[-1])
    protoutil.set_block_txflags(last, bytes(expected[-1]))
    crashed.blockstore.add_block(last)
    crashed.close()
    reopened = KvLedger("ch", str(tmp_path / "crash"))
    assert reopened.replayed_blocks == 1
    assert reopened.height == clean.height == len(blocks)
    assert reopened.state_fingerprint() == reopened.state_fingerprint_full() \
        == clean.state_fingerprint()
    keys = _keys(clean)
    assert _histories(reopened, keys) == _histories(clean, keys)
    assert [list(protoutil.block_txflags(b))
            for b in reopened.blockstore.iter_blocks()] == expected
    # the reference reopens the crashed directory to the same state
    reopened.close()
    jled = JKvLedger(str(tmp_path / "crash"), "ch")
    assert jled.state_fingerprint() == clean.state_fingerprint()
    jled.close()
    clean.close()


def test_abandoned_ledger_reopens_like_the_reference(stream, tmp_path):
    """A ledger left without close() (a process kill): its state log
    holds every synced block, and both packages reopen it to the same
    state; the port's reopen replays no state block."""
    _world, (blocks, expected) = stream
    d = str(tmp_path / "kill")
    led = KvLedger("ch", d)
    for raw, flags in zip(blocks, expected):
        led.commit_block(m.Block.decode(raw), flags)
    want = led.state_fingerprint()
    keys = _keys(led)
    hist = _histories(led, keys)
    again = KvLedger("ch", d)              # `led` stays open, unflushed
    assert again.replayed_blocks == 0
    assert again.state_fingerprint() == want
    assert _histories(again, keys) == hist
    jled = JKvLedger(d, "ch")
    assert jled.state_fingerprint() == want
    jled.close()
    again.close()
    led.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ledger_directory_opens_in_the_other_package(stream, tmp_path, writer):
    _world, (blocks, expected) = stream
    d = str(tmp_path / "led")
    first = KvLedger("ch", d) if writer == "port" else JKvLedger(d, "ch")
    mod = m if writer == "port" else jm
    for raw, flags in zip(blocks[:3], expected[:3]):
        first.commit_block(mod.Block.decode(raw), flags)
    want = first.state_fingerprint()
    first.close()
    other = JKvLedger(d, "ch") if writer == "port" else KvLedger("ch", d)
    omod = jm if writer == "port" else m
    assert other.state_fingerprint() == want
    # commits on past the other package's blocks
    assert other.commit_block(omod.Block.decode(blocks[3]), expected[3]) == \
        expected[3]
    want = other.state_fingerprint()
    other.close()
    back = KvLedger("ch", d) if writer == "port" else JKvLedger(d, "ch")
    assert back.state_fingerprint() == want
    if writer == "port":
        assert back.replayed_blocks == 0
    back.close()


def test_clean_reopen_replays_nothing(stream, tmp_path):
    _world, (blocks, expected) = stream
    mgr = LedgerManager(str(tmp_path / "ledgers"))
    led = mgr.create_or_open("ch")
    for raw, flags in zip(blocks, expected):
        led.commit_block(m.Block.decode(raw), flags)
    want = led.state_fingerprint()
    mgr.close()
    again = LedgerManager(str(tmp_path / "ledgers"))
    assert again.ledger_ids() == ["ch"]
    led2 = again.create_or_open("ch")
    assert led2.replayed_blocks == 0
    assert led2.state.savepoint == led2.history.savepoint == \
        led2.confighistory.savepoint == len(blocks) - 1
    assert led2.state_fingerprint() == want
    again.close()


def test_memory_ledger_snapshot_bounds_replay(stream, tmp_path, monkeypatch):
    """durable=False: in-memory history, state snapshotted every
    SNAPSHOT_EVERY blocks; a reopen replays state past the snapshot
    only, and both packages read the snapshot."""
    _world, (blocks, expected) = stream
    monkeypatch.setattr(KvLedger, "SNAPSHOT_EVERY", 3)
    d = str(tmp_path / "mem")
    led = KvLedger("ch", d, durable=False)
    for raw, flags in zip(blocks, expected):
        led.commit_block(m.Block.decode(raw), flags)
    want = led.state_fingerprint()
    keys = _keys(led)
    hist = _histories(led, keys)
    led.blockstore.close()                 # abandon: no close snapshot
    again = KvLedger("ch", d, durable=False)
    assert again.replayed_blocks == 1      # snapshotted after block 2
    assert again.state_fingerprint() == want
    assert _histories(again, keys) == hist  # history rebuilt from genesis
    again.close()
    jled = JKvLedger(d, "ch", durable=False)
    assert jled.state_fingerprint() == want
    jled.close()


def test_transaction_lookup_and_manager_guards(stream, tmp_path):
    _world, (blocks, expected) = stream
    led = KvLedger("ch", str(tmp_path / "g"))
    led.commit_block(m.Block.decode(blocks[0]), expected[0])
    txid = protoutil.envelope_channel_header(
        protoutil.get_envelopes(m.Block.decode(blocks[0]))[0]).tx_id
    assert led.get_transaction_by_id(txid).validation_code == expected[0][0]
    # a txid the index knows whose block cannot be read
    led.blockstore._by_num.pop(0)
    assert led.get_transaction_by_id(txid) is None
    led.close()
    mgr = LedgerManager(str(tmp_path / "mgr"))
    import shutil
    shutil.rmtree(str(tmp_path / "mgr"))
    assert mgr.ledger_ids() == []


def test_state_scale_stream_durable_and_memory_equal_reference(tmp_path):
    """bench.py:745's stream at a small size: a durable and a
    durable=False port ledger, each prefilled, committed by the port's
    Committer (host verifier, columnar decode, vectorized MVCC), and a
    durable reference ledger fed the same blocks and flags: equal flags
    (more kinds than VALID), equal fingerprints, incremental == full,
    no body-decode fallback row."""
    from fabric_mod_tpu.ledger.statedb import UpdateBatch as JUpdateBatch
    world = fixtures.make_commit_world()
    blocks = fixtures.make_statescale_blocks(world, 4, 24, 2000)
    arms = {}
    for durable in (True, False):
        led = KvLedger(world.channel_id, str(tmp_path / f"a{durable}"),
                       durable=durable)
        fixtures.prefill_statescale(led, 3000)
        led.state_fingerprint()
        committer = world.committer(sw.SwVerifier(), ledger=led)
        flags = []
        for raw in blocks:
            flags.append(committer.store_block(m.Block.decode(raw)))
            assert committer.last_timings["body_fallbacks"] == 0
        assert led.state_fingerprint() == led.state_fingerprint_full()
        arms[durable] = (flags, led.state_fingerprint())
        led.close()
    assert arms[True] == arms[False]
    flags, fp = arms[True]
    assert len({f for blk in flags for f in blk}) > 1
    jled = JKvLedger(str(tmp_path / "ref"), world.channel_id)
    batch = JUpdateBatch()
    for i in range(3000):
        batch.put(NS, fixtures.statescale_key(i), b"seed-%07d" % i, (0, 0))
    jled.state.apply_updates(batch, 0)
    for raw, want in zip(blocks, flags):
        assert jled.commit_block(jm.Block.decode(raw), want) == want
    assert jled.state_fingerprint() == fp
    jled.close()
