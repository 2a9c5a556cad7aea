"""Operator ledger commands: reset, rollback, rebuild-dbs.

The port's copy of fabric_mod_tpu/ledger/admin.py (reference:
internal/peer/node/{reset,rollback,rebuild_dbs}.go and
core/ledger/kvledger/rollback.go:16 — offline maintenance run against a
stopped peer's ledger directory).  It drops exactly what the reference
drops (`state/`, `history/`, `state.snap`); the config history and the
private-data stores stay, and the reopen replays every block into the
rebuilt stores.
"""
from __future__ import annotations

import os
import shutil
import struct

from fabric_mod_tpu_torch.ledger.blkstorage import BlockStore


class AdminError(Exception):
    pass


def _require_ledger(ledger_dir: str) -> None:
    if not os.path.isdir(os.path.join(ledger_dir, "chains")):
        raise AdminError(f"{ledger_dir} holds no ledger")


def _bootstrap_base(ledger_dir: str) -> int:
    """Base height of a snapshot-bootstrapped store (0 = full chain)."""
    marker = os.path.join(ledger_dir, "chains", BlockStore.BASE_MARKER)
    if not os.path.exists(marker):
        return 0
    with open(marker, "rb") as f:
        raw = f.read()
    return struct.unpack_from("<q", raw, 0)[0] if len(raw) >= 8 else 0


def rebuild_dbs(ledger_dir: str) -> None:
    """Drop all derived stores (state/history); the next open rebuilds
    them from the block store (reference: rebuild_dbs.go — the ledger
    IS the checkpoint, SURVEY §5.4).  Refused on snapshot-bootstrapped
    ledgers: the pre-snapshot state is NOT derivable from local blocks
    — re-join from a snapshot instead."""
    _require_ledger(ledger_dir)
    if _bootstrap_base(ledger_dir) > 0:
        raise AdminError(
            "ledger was bootstrapped from a snapshot: its state cannot "
            "be rebuilt from local blocks — re-join from a snapshot")
    for sub in ("state", "history"):
        path = os.path.join(ledger_dir, sub)
        if os.path.isdir(path):
            shutil.rmtree(path)
    snap = os.path.join(ledger_dir, "state.snap")
    if os.path.exists(snap):
        os.remove(snap)


# reset is rebuild-dbs in the reference's terms (state from blocks);
# kept as its own name for CLI parity
reset = rebuild_dbs


def rollback(ledger_dir: str, target_block: int) -> None:
    """Truncate the chain to `target_block` (inclusive) and drop the
    derived stores (reference: rollback.go:16 — offline block-store
    rollback + forced reconstruction).  Bootstrapped ledgers cannot
    roll back at all: their state below the tip is not reconstructible
    from local blocks."""
    _require_ledger(ledger_dir)
    if _bootstrap_base(ledger_dir) > 0:
        raise AdminError(
            "ledger was bootstrapped from a snapshot: rollback would "
            "need pre-snapshot blocks that were pruned")
    chains = os.path.join(ledger_dir, "chains")
    store = BlockStore(chains)
    if target_block >= store.height:
        store.close()
        raise AdminError(
            f"target {target_block} >= height {store.height}")
    blocks = [store.get_block_by_number(i)
              for i in range(target_block + 1)]
    if any(b is None for b in blocks):
        store.close()
        raise AdminError("missing blocks: cannot roll back")
    store.close()
    tmp = chains + ".rollback"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    new_store = BlockStore(tmp)
    for b in blocks:
        new_store.add_block(b)
    new_store.close()
    shutil.rmtree(chains)
    os.replace(tmp, chains)
    rebuild_dbs(ledger_dir)
