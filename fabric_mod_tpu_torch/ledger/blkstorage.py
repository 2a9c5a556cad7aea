"""Append-only block file store with a block-number and tx-id index.

The port's copy of fabric_mod_tpu/ledger/blkstorage.py `BlockStore`
(:43; reference: common/ledger/blkstorage/blockfile_mgr.go — rolling
block files with length-prefixed records, an index by number and txid,
and reconstruction by scanning on open; blockfile_helper.go crops torn
writes), without the snapshot-bootstrap base marker and the pruned-txid
import.

Record format per block:  u32 payload_len ‖ payload ‖ sha256(payload)
— the trailing digest makes a torn tail write detectable; recovery
truncates the file at the last whole record.  The in-memory index
(number -> (file, offset), txid -> (number, txpos)) is rebuilt by the
scan on open, which doubles as the integrity pass.
"""
from __future__ import annotations

import hashlib
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

_MAX_FILE = 64 * 1024 * 1024


class BlockStoreError(Exception):
    pass


def _tx_ids(block: m.Block) -> List[str]:
    ids = []
    for env in protoutil.get_envelopes(block):
        try:
            ids.append(protoutil.envelope_channel_header(env).tx_id)
        except Exception:
            ids.append("")
    return ids


class BlockStore:
    """One channel's block files under `dir_path`."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(dir_path, exist_ok=True)
        self._by_num: Dict[int, Tuple[int, int]] = {}    # num -> (file, off)
        self._by_txid: Dict[str, Tuple[int, int]] = {}   # txid -> (num, pos)
        self._height = 0
        self._last_hash = b""
        self._cur_file = 0
        self._recover()
        self._fh = open(self._file_path(self._cur_file), "ab")

    # -- file layout -----------------------------------------------------
    def _file_path(self, n: int) -> str:
        return os.path.join(self.dir, f"blockfile_{n:06d}")

    def _files(self) -> List[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("blockfile_"))

    # -- recovery scan ---------------------------------------------------
    def _recover(self) -> None:
        files = self._files()
        if not files:
            return
        stopped_at = files[-1]
        for fno in files:
            path = self._file_path(fno)
            with open(path, "rb") as f:
                raw = f.read()
            pos = good_end = 0
            while pos + 4 <= len(raw):
                (ln,) = struct.unpack_from("<I", raw, pos)
                end = pos + 4 + ln + 32
                if end > len(raw):
                    break                       # torn tail
                payload = raw[pos + 4:pos + 4 + ln]
                if hashlib.sha256(payload).digest() != raw[pos + 4 + ln:end]:
                    break                       # corruption: crop here
                block = m.Block.decode(payload)
                num = block.header.number
                if num != self._height:
                    raise BlockStoreError(
                        f"block {num} out of order (height {self._height})")
                self._index_block(block, fno, pos)
                self._height = num + 1
                self._last_hash = protoutil.block_header_hash(block.header)
                pos = good_end = end
            if good_end < len(raw):             # crop the torn/corrupt tail
                with open(path, "r+b") as f:
                    f.truncate(good_end)
                stopped_at = fno
                break
        # anything after a cropped file cannot be contiguous: drop it
        for fno in files:
            if fno > stopped_at:
                os.remove(self._file_path(fno))
        self._cur_file = stopped_at

    def _index_block(self, block: m.Block, fno: int, off: int) -> None:
        num = block.header.number
        self._by_num[num] = (fno, off)
        for pos, txid in enumerate(_tx_ids(block)):
            if txid and txid not in self._by_txid:
                self._by_txid[txid] = (num, pos)

    # -- writes ----------------------------------------------------------
    def add_block(self, block: m.Block) -> None:
        num = block.header.number
        if num != self._height:
            raise BlockStoreError(
                f"expected block {self._height}, got {num}")
        if self._height > 0 and block.header.previous_hash != self._last_hash:
            raise BlockStoreError(f"block {num} previous_hash mismatch")
        payload = block.encode()
        if self._fh.tell() > _MAX_FILE:
            self._fh.close()
            self._cur_file += 1
            self._fh = open(self._file_path(self._cur_file), "ab")
        off = self._fh.tell()
        self._fh.write(struct.pack("<I", len(payload)))
        self._fh.write(payload)
        self._fh.write(hashlib.sha256(payload).digest())
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._index_block(block, self._cur_file, off)
        self._height = num + 1
        self._last_hash = protoutil.block_header_hash(block.header)

    # -- reads -----------------------------------------------------------
    @property
    def height(self) -> int:
        return self._height

    @property
    def last_block_hash(self) -> bytes:
        return self._last_hash

    def get_block_by_number(self, num: int) -> Optional[m.Block]:
        loc = self._by_num.get(num)
        if loc is None:
            return None
        fno, off = loc
        with open(self._file_path(fno), "rb") as f:
            f.seek(off)
            (ln,) = struct.unpack("<I", f.read(4))
            return m.Block.decode(f.read(ln))

    def get_tx_loc(self, txid: str) -> Optional[Tuple[int, int]]:
        return self._by_txid.get(txid)

    def iter_blocks(self, start: int = 0) -> Iterator[m.Block]:
        for num in range(start, self._height):
            yield self.get_block_by_number(num)

    def close(self) -> None:
        self._fh.close()
