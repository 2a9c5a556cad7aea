"""Ledger snapshots: deterministic export + bootstrap import.

The port's copy of fabric_mod_tpu/ledger/snapshot.py, in the same file
format, so a snapshot made by either package bootstraps a ledger of the
other (reference: core/ledger/kvledger/snapshot.go:31-97 — the
generateSnapshot files (state data, txids, metadata + a signable
metadata summary with file hashes) — and the CreateFromSnapshot
bootstrap path of kv_ledger_provider.go:764: a new peer joins at
height H with the state but without blocks 0..H-1.)

File layout under <out>/:
  state.dat   checksummed (ns, key, value, version) records, sorted
  txids.dat   checksummed sorted txid list
  _snapshot_signable_metadata.json
              {channel, height, last_block_hash, files: {name: sha256}}
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import struct
from typing import Dict

from fabric_mod_tpu_torch.ledger.blkstorage import BlockStore
from fabric_mod_tpu_torch.ledger.statedb import UpdateBatch
from fabric_mod_tpu_torch.protos import protoutil

METADATA_FILE = "_snapshot_signable_metadata.json"


class SnapshotError(Exception):
    pass


def _write_sealed(path: str, body: bytes) -> str:
    digest = hashlib.sha256(body).hexdigest()
    with open(path, "wb") as f:
        f.write(body)
        f.flush()
        os.fsync(f.fileno())
    return digest


def _pack(out: io.BytesIO, b: bytes) -> None:
    out.write(struct.pack("<I", len(b)))
    out.write(b)


def generate_snapshot(ledger, out_dir: str) -> Dict:
    """Export the ledger's state at its current height
    (reference: snapshot.go generateSnapshot)."""
    os.makedirs(out_dir, exist_ok=True)
    height = ledger.height
    if height == 0:
        raise SnapshotError("cannot snapshot an empty ledger")
    tip = ledger.get_block_by_number(height - 1)
    last_hash = protoutil.block_header_hash(tip.header)

    state = io.BytesIO()
    count = 0
    for ns, key, value, (bn, tn) in ledger.state.iter_state():
        _pack(state, ns.encode())
        _pack(state, key.encode())
        _pack(state, value)
        state.write(struct.pack("<qq", bn, tn))
        # key metadata rides along (state-based endorsement policies
        # must survive a snapshot join)
        meta = ledger.state.get_metadata(ns, key) or {}
        state.write(struct.pack("<I", len(meta)))
        for name, val in sorted(meta.items()):
            _pack(state, name.encode())
            _pack(state, val)
        count += 1
    txids = io.BytesIO()
    for txid in sorted(ledger.blockstore.all_txids()):
        _pack(txids, txid.encode())

    files = {
        "state.dat": _write_sealed(
            os.path.join(out_dir, "state.dat"), state.getvalue()),
        "txids.dat": _write_sealed(
            os.path.join(out_dir, "txids.dat"), txids.getvalue()),
    }
    meta = {
        "channel": ledger.ledger_id,
        "height": height,
        "last_block_hash": last_hash.hex(),
        "state_entries": count,
        "files": files,
    }
    with open(os.path.join(out_dir, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


def verify_snapshot(snap_dir: str) -> Dict:
    """Checksum-verify a snapshot directory; returns its metadata."""
    with open(os.path.join(snap_dir, METADATA_FILE)) as f:
        meta = json.load(f)
    for name, want in meta["files"].items():
        with open(os.path.join(snap_dir, name), "rb") as f:
            raw = f.read()
        if hashlib.sha256(raw).hexdigest() != want:
            raise SnapshotError(f"checksum mismatch in {name}")
    return meta


def bootstrap_from_snapshot(snap_dir: str, ledger_dir: str,
                            durable: bool = True):
    """Create a new ledger at the snapshot height: state seeded, block
    store based above the pruned range (reference:
    kv_ledger_provider.go CreateFromSnapshot).  The state enters at
    savepoint height-1 through the ledger's one state-mutation path, so
    recovery never replays the pruned range and the incremental
    fingerprint cannot go stale."""
    from fabric_mod_tpu_torch.ledger.kvledger import KvLedger
    meta = verify_snapshot(snap_dir)
    if os.path.exists(os.path.join(ledger_dir, "chains")):
        raise SnapshotError(f"{ledger_dir} already holds a ledger")
    height = meta["height"]
    chains = os.path.join(ledger_dir, "chains")
    BlockStore.write_base_marker(
        chains, height, bytes.fromhex(meta["last_block_hash"]))
    # seed the pruned-range txid index so duplicate-txid detection
    # still works on the joined peer
    with open(os.path.join(snap_dir, "txids.dat"), "rb") as f:
        raw_tx = f.read()
    txids = []
    pos = 0
    while pos < len(raw_tx):
        (ln,) = struct.unpack_from("<I", raw_tx, pos)
        pos += 4
        txids.append(raw_tx[pos:pos + ln].decode())
        pos += ln
    BlockStore.write_pruned_txids(chains, txids)
    led = KvLedger(meta["channel"], ledger_dir, durable=durable)
    # seed state at savepoint height-1 so recovery never replays the
    # pruned range
    with open(os.path.join(snap_dir, "state.dat"), "rb") as f:
        raw = f.read()
    batch = UpdateBatch()
    pos = 0
    while pos < len(raw):
        parts = []
        for _ in range(3):
            (ln,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            parts.append(raw[pos:pos + ln])
            pos += ln
        bn, tn = struct.unpack_from("<qq", raw, pos)
        pos += 16
        ns, key = parts[0].decode(), parts[1].decode()
        batch.put(ns, key, parts[2], (bn, tn))
        (n_meta,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        entries = {}
        for _ in range(n_meta):
            (ln,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            name = raw[pos:pos + ln].decode()
            pos += ln
            (ln,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            entries[name] = raw[pos:pos + ln]
            pos += ln
        if entries:
            batch.put_metadata(ns, key, entries, (bn, tn))
    led._apply_state_updates(batch, height - 1)
    return led
