"""Historical collection configs from committed lifecycle writes.

The port's copy of fabric_mod_tpu/ledger/confighistory.py
`ConfigHistoryManager` (:49; reference: core/ledger/confighistory/
mgr.go — the retriever answering "what was this chaincode's collection
config as of block N", which private-data reconciliation needs when a
config changed after the data's block).  The file formats (a JSONL
record per definition, a `.sp` savepoint file) are the reference's, so
the history opens in either package.

KvLedger calls `handle_block_writes` from its commit AND its recovery
replay, so the file-backed history heals from the block store the way
state does; records are idempotent per (block, namespace).  The
reference's chaincode-definition listeners (cceventmgmt) are left out:
nothing in the port registers one.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.protos import messages as m

LIFECYCLE_NS = "_lifecycle"


class ConfigHistoryManager:
    """Records every committed (block, chaincode, collection config)
    and answers most-recent-below queries; an append-only JSONL file, so
    reopening is O(history), not O(chain)."""

    SP_EVERY = 256                       # savepoint persistence cadence

    def __init__(self, path: str):
        self._path = path
        self._since_sp_write = 0
        self._lock = RegisteredLock("ledger.confighistory._lock")
        # ns -> sorted [(block_num, collections bytes)]
        self._by_ns: Dict[str, List[Tuple[int, bytes]]] = {}
        # the last block OFFERED (not merely recorded): the ledger's
        # recovery floor — blocks above it must be replayed through
        # handle_block_writes, or a definition would be lost to a crash
        # between the state commit and this write
        self.savepoint = -1
        if os.path.exists(path):
            good_end = 0
            last_block = -1
            with open(path, "rb") as f:
                data = f.read()
            for line in data.splitlines(keepends=True):
                try:
                    rec = json.loads(line)
                    block = rec["block"]
                    self._insert(rec["ns"], block,
                                 base64.b64decode(rec["collections"]))
                except (ValueError, KeyError, TypeError):
                    break                  # torn tail: cropped below
                last_block = max(last_block, block)
                good_end += len(line)
            if good_end < len(data):
                with open(path, "r+b") as f:
                    f.truncate(good_end)
            sp = -1
            sp_path = path + ".sp"
            if os.path.exists(sp_path):
                try:
                    sp = int(open(sp_path).read())
                except ValueError:
                    sp = -1
            # a torn record invalidates the persisted savepoint: fall
            # back to the last intact record, so recovery re-offers the
            # rest of the chain
            self.savepoint = (min(sp, last_block)
                              if good_end < len(data) else sp)

    def _insert(self, ns: str, block_num: int, collections: bytes) -> None:
        lst = self._by_ns.setdefault(ns, [])
        if lst and lst[-1][0] == block_num:
            lst[-1] = (block_num, collections)
        else:
            lst.append((block_num, collections))

    def handle_block_writes(self, block_num: int,
                            writes: List[Tuple[str, str, Optional[bytes]]]
                            ) -> None:
        """Scan one committed block's (ns, key, value) writes for
        lifecycle definitions and record their collection configs."""
        with self._lock:
            if block_num <= self.savepoint:
                return                     # replay of an offered block
            recorded = False
            for ns, key, value in writes:
                if ns != LIFECYCLE_NS or value is None:
                    continue
                if not key.startswith("namespaces/") or "/" in \
                        key[len("namespaces/"):]:
                    continue               # only the definition records
                cc_name = key[len("namespaces/"):]
                try:
                    d = m.ChaincodeDefinition.decode(value)
                except ValueError:
                    continue               # not a definition: ignored
                known = self._by_ns.get(cc_name, [])
                if known and known[-1][0] >= block_num:
                    continue               # replay of a recorded block
                self._insert(cc_name, block_num, d.collections)
                with open(self._path, "a") as f:
                    f.write(json.dumps({
                        "ns": cc_name, "block": block_num,
                        "collections": base64.b64encode(
                            d.collections).decode()}) + "\n")
                recorded = True
            self.savepoint = block_num
            # persist the savepoint only when a record landed or every
            # SP_EVERY blocks: the commit path must not pay a file
            # rename per block; a stale savepoint merely replays
            # (idempotent), it never loses records
            self._since_sp_write += 1
            if recorded or self._since_sp_write >= self.SP_EVERY:
                self._write_savepoint()

    def _write_savepoint(self) -> None:
        self._since_sp_write = 0
        tmp = self._path + ".sp.tmp"
        with open(tmp, "w") as f:
            f.write(str(self.savepoint))
        os.replace(tmp, self._path + ".sp")

    def close(self) -> None:
        """Persist the savepoint, so a clean reopen replays nothing for
        the config history (the reference leaves it up to SP_EVERY
        blocks stale, which only re-offers blocks; both read it)."""
        with self._lock:
            if self._since_sp_write:
                self._write_savepoint()

    def most_recent_collection_config_below(
            self, ns: str, block_num: int
            ) -> Optional[Tuple[int, m.CollectionConfigPackage]]:
        """The collection config in force for data written at
        `block_num`: the newest definition committed STRICTLY below
        it.  None when no definition predates the block."""
        with self._lock:
            for bn, raw in reversed(self._by_ns.get(ns, [])):
                if bn < block_num:
                    if not raw:
                        return None
                    try:
                        return bn, m.CollectionConfigPackage.decode(raw)
                    except ValueError:
                        return None
        return None

    def collection_config_history(self, ns: str
                                  ) -> List[Tuple[int, bytes]]:
        with self._lock:
            return list(self._by_ns.get(ns, []))
