"""Ledger snapshots and the operator commands on the port: the
reference's tests/test_snapshot.py cases, then across packages — the
port's snapshot of the same committed blocks is byte-identical to the
reference's, and each package bootstraps from the other's snapshot to
equal fingerprints after the same later blocks."""
import hashlib
import os

import pytest

from fabric_mod_tpu_torch.ledger import admin
from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
from fabric_mod_tpu_torch.ledger.rwsetutil import RWSetBuilder
from fabric_mod_tpu_torch.ledger.snapshot import (
    METADATA_FILE, SnapshotError, bootstrap_from_snapshot, generate_snapshot,
    verify_snapshot)
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

V = m.TxValidationCode.VALID


def _make_block(num, prev, n_txs):
    envs = []
    for i in range(n_txs):
        b = RWSetBuilder()
        b.add_write("cc", f"k{num}-{i}", b"v%d" % num)
        if i == 1:
            b.add_metadata_write("cc", f"k{num}-{i}", "VALIDATION_PARAMETER",
                                 b"pin%d" % num)
        ch = protoutil.make_channel_header(
            m.HeaderType.ENDORSER_TRANSACTION, "ch", tx_id=f"tx{num}-{i}")
        sh = protoutil.make_signature_header(b"c", b"n")
        tx = m.Transaction(actions=[m.TransactionAction(
            payload=m.ChaincodeActionPayload(
                action=m.ChaincodeEndorsedAction(
                    proposal_response_payload=m.ProposalResponsePayload(
                        extension=m.ChaincodeAction(
                            results=b.build().encode()).encode()
                    ).encode())).encode())])
        payload = protoutil.make_payload(ch, sh, tx.encode())
        envs.append(m.Envelope(payload=payload.encode()))
    return protoutil.new_block(num, prev, envs)


def _fill(led, n_blocks, txs_per_block=3):
    prev = (protoutil.block_header_hash(
        led.get_block_by_number(led.height - 1).header)
        if led.height else b"")
    for num in range(led.height, led.height + n_blocks):
        blk = _make_block(num, prev, txs_per_block)
        led.commit_block(blk, [V] * txs_per_block)
        prev = protoutil.block_header_hash(blk.header)


def test_snapshot_roundtrip_and_bootstrap(tmp_path):
    led = KvLedger("ch", str(tmp_path / "src"))
    _fill(led, 6)
    snap = str(tmp_path / "snap")
    meta = generate_snapshot(led, snap)
    assert meta["height"] == 6
    assert verify_snapshot(snap)["channel"] == "ch"
    led2 = bootstrap_from_snapshot(snap, str(tmp_path / "joined"))
    assert led2.height == 6
    assert led2.state.get_state("cc", "k3-1")[0] == b"v3"
    assert led2.get_block_by_number(2) is None
    assert led2.state_fingerprint() == led.state_fingerprint() == \
        led2.state_fingerprint_full()
    tip = led.get_block_by_number(5)
    blk6 = _make_block(6, protoutil.block_header_hash(tip.header), 2)
    led2.commit_block(blk6, [V] * 2)
    assert led2.height == 7
    assert led2.state.get_state("cc", "k6-0")[0] == b"v6"
    assert led2.state_fingerprint() == led2.state_fingerprint_full()
    led2.close()
    # reopen: recovery must not reach into the pruned range
    led3 = KvLedger("ch", str(tmp_path / "joined"))
    assert led3.height == 7 and led3.replayed_blocks == 0
    assert led3.state.get_state("cc", "k6-1")[0] == b"v6"
    led3.close()
    led.close()


def test_snapshot_preserves_metadata_and_txids(tmp_path):
    """Key metadata and the pruned range's tx ids survive the join."""
    led = KvLedger("ch", str(tmp_path / "src"))
    _fill(led, 3)
    batch = UpdateBatch()
    batch.put_metadata("cc", "k1-0", {"VALIDATION_PARAMETER": b"pinned"},
                       (2, 99))
    led.state.apply_updates(batch, led.state.savepoint)
    snap = str(tmp_path / "snap")
    generate_snapshot(led, snap)
    led2 = bootstrap_from_snapshot(snap, str(tmp_path / "joined"))
    assert led2.state.get_metadata("cc", "k1-0") == {
        "VALIDATION_PARAMETER": b"pinned"}
    assert led2.tx_id_exists("tx1-0")
    assert led2.get_transaction_by_id("tx1-0") is None   # block pruned
    assert led2.blockstore.get_block_by_txid("tx1-0") is None
    led2.close()
    led3 = KvLedger("ch", str(tmp_path / "joined"))
    assert led3.tx_id_exists("tx2-1")
    led3.close()
    led.close()


def test_admin_refuses_bootstrapped_ledgers(tmp_path):
    led = KvLedger("ch", str(tmp_path / "src"))
    _fill(led, 3)
    snap = str(tmp_path / "snap")
    generate_snapshot(led, snap)
    led.close()
    joined = str(tmp_path / "joined")
    bootstrap_from_snapshot(snap, joined).close()
    with pytest.raises(admin.AdminError):
        admin.rebuild_dbs(joined)
    with pytest.raises(admin.AdminError):
        admin.rollback(joined, 1)
    with pytest.raises(SnapshotError):
        bootstrap_from_snapshot(snap, joined)       # already a ledger


def test_snapshot_checksum_tamper_detected(tmp_path):
    led = KvLedger("ch", str(tmp_path / "src"))
    _fill(led, 2)
    snap = str(tmp_path / "snap")
    generate_snapshot(led, snap)
    with open(os.path.join(snap, "state.dat"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff")
    with pytest.raises(SnapshotError):
        verify_snapshot(snap)
    led.close()


def test_rebuild_dbs_rebuilds_from_blocks(tmp_path):
    d = str(tmp_path / "led")
    led = KvLedger("ch", d)
    _fill(led, 4)
    fp = led.state_fingerprint()
    led.close()
    admin.rebuild_dbs(d)
    assert not os.path.isdir(os.path.join(d, "state"))
    led2 = KvLedger("ch", d)
    assert led2.height == 4 and led2.replayed_blocks == 4
    assert led2.state.get_state("cc", "k2-0")[0] == b"v2"
    assert led2.history.get_history_for_key("cc", "k2-0") == [(2, 0)]
    assert led2.state_fingerprint() == fp
    led2.close()


def test_reset_rebuilds_and_refuses_as_rebuild_dbs(tmp_path):
    """`reset`, the reference's name for the same command, rebuilds a
    ledger's databases from its blocks and refuses a bootstrapped one."""
    d = str(tmp_path / "led")
    led = KvLedger("ch", d)
    _fill(led, 3)
    fp = led.state_fingerprint()
    snap = str(tmp_path / "snap")
    generate_snapshot(led, snap)
    led.close()
    admin.reset(d)
    assert not os.path.isdir(os.path.join(d, "history"))
    again = KvLedger("ch", d)
    assert again.replayed_blocks == 3 and again.state_fingerprint() == fp
    again.close()
    joined = str(tmp_path / "joined")
    bootstrap_from_snapshot(snap, joined).close()
    with pytest.raises(admin.AdminError):
        admin.reset(joined)


def test_rollback_truncates_and_rebuilds(tmp_path):
    d = str(tmp_path / "led")
    led = KvLedger("ch", d)
    _fill(led, 6)
    blocks = [led.get_block_by_number(n) for n in (3, 4, 5)]
    fp = led.state_fingerprint()
    led.close()
    admin.rollback(d, 2)
    led2 = KvLedger("ch", d)
    assert led2.height == 3
    assert led2.state.get_state("cc", "k2-0")[0] == b"v2"
    assert led2.state.get_state("cc", "k4-0") is None
    for blk in blocks:                       # recommit: the same state
        led2.commit_block(m.Block.decode(blk.encode()))
    assert led2.state_fingerprint() == fp == led2.state_fingerprint_full()
    led2.close()
    with pytest.raises(admin.AdminError):
        admin.rollback(d, 99)


# --- across packages ----------------------------------------------------------

def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _ref_ledger(path):
    from fabric_mod_tpu.ledger.kvledger import KvLedger as JKvLedger
    return JKvLedger(path, "ch")


def _to_ref(blk):
    from fabric_mod_tpu.protos import messages as jm
    return jm.Block.decode(blk.encode())


def test_snapshots_are_byte_identical_across_packages(tmp_path):
    """The same committed blocks give the same snapshot files (sha256s)
    and the same metadata in both packages."""
    from fabric_mod_tpu.ledger.snapshot import (
        generate_snapshot as j_generate_snapshot)
    led = KvLedger("ch", str(tmp_path / "port"))
    jled = _ref_ledger(str(tmp_path / "ref"))
    try:
        _fill(led, 5, 4)
        for n in range(led.height):
            jled.commit_block(_to_ref(led.get_block_by_number(n)))
        meta = generate_snapshot(led, str(tmp_path / "psnap"))
        jmeta = j_generate_snapshot(jled, str(tmp_path / "jsnap"))
        assert meta == jmeta
        for name in ("state.dat", "txids.dat", METADATA_FILE):
            assert _sha(tmp_path / "psnap" / name) == \
                _sha(tmp_path / "jsnap" / name)
        assert led.snapshot_to(str(tmp_path / "psnap2")) == meta
    finally:
        led.close()
        jled.close()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_bootstrap_across_packages(tmp_path, direction):
    """A snapshot made by one package bootstraps a ledger of the other;
    both sides then commit the same two blocks to equal fingerprints,
    and the pruned range's tx ids are known on the joined side."""
    from fabric_mod_tpu.ledger.snapshot import (
        bootstrap_from_snapshot as j_bootstrap,
        generate_snapshot as j_generate_snapshot)
    src = KvLedger("ch", str(tmp_path / "port"))
    jsrc = _ref_ledger(str(tmp_path / "ref"))
    _fill(src, 4)
    for n in range(src.height):
        jsrc.commit_block(_to_ref(src.get_block_by_number(n)))
    snap = str(tmp_path / "snap")
    if direction == "ref_to_port":
        j_generate_snapshot(jsrc, snap)
        joined = bootstrap_from_snapshot(snap, str(tmp_path / "joined"))
        to_joined = (lambda b: b)
    else:
        generate_snapshot(src, snap)
        joined = j_bootstrap(snap, str(tmp_path / "joined"))
        to_joined = _to_ref
    try:
        assert joined.state_fingerprint() == src.state_fingerprint() == \
            jsrc.state_fingerprint()
        tip = src.get_block_by_number(src.height - 1)
        prev = protoutil.block_header_hash(tip.header)
        for num in (4, 5):
            blk = _make_block(num, prev, 3)
            prev = protoutil.block_header_hash(blk.header)
            src.commit_block(m.Block.decode(blk.encode()), [V] * 3)
            jsrc.commit_block(_to_ref(blk), [V] * 3)
            joined.commit_block(to_joined(m.Block.decode(blk.encode())),
                                [V] * 3)
        assert joined.state_fingerprint() == src.state_fingerprint() == \
            jsrc.state_fingerprint()
        assert joined.tx_id_exists("tx1-2")
    finally:
        joined.close()
        src.close()
        jsrc.close()
