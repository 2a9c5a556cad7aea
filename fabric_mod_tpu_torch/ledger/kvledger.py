"""A lean in-memory ledger: blocks + versioned state, MVCC commit and
the state fingerprint.

The port of fabric_mod_tpu/ledger/kvledger.py's commit path
(`commit_block`, :369-474; reference: core/ledger/kvledger/
kv_ledger.go:457 CommitLegacy) without the private-data, history,
config-history, durable-store and snapshot branches: MVCC validate ->
append the block (flags in its metadata) -> apply the state batch.

`state_fingerprint` uses the reference's exact row, metadata and height
encoding (`_fp_row`, `_fp_meta`, `_fp_scan_acc`, `state_fingerprint`,
:688-785), so a port ledger and a JAX-package ledger that committed the
same blocks with the same flags give the same hex digest.  It scans the
whole state on every call (the reference folds each commit into a
cached accumulator; the digest is the same).
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.ledger.mvcc import validate_and_prepare_batch
from fabric_mod_tpu_torch.ledger.statedb import VersionedDB
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil

Version = Tuple[int, int]


class LedgerError(Exception):
    pass


def tx_rwset_from_envelope(env: m.Envelope) -> Optional[m.TxReadWriteSet]:
    """Envelope -> TxReadWriteSet of its (first) endorser action, or
    None when absent/malformed."""
    try:
        payload = protoutil.unmarshal_envelope_payload(env)
        tx = protoutil.extract_endorser_tx(payload)
        cca, _prp, _ends = protoutil.tx_rwset_and_endorsements(tx.actions[0])
        return m.TxReadWriteSet.decode(cca.results)
    except Exception:
        return None


def _fp_entry(tag: bytes, ns: str, key: str, tail: bytes) -> int:
    h = hashlib.sha256(tag)
    for part in (ns.encode(), key.encode()):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    h.update(tail)
    return int.from_bytes(h.digest(), "big")


def _fp_row(ns: str, key: str, value: bytes, ver: Version) -> int:
    tail = (len(value).to_bytes(4, "big") + value
            + ver[0].to_bytes(8, "big") + ver[1].to_bytes(8, "big"))
    return _fp_entry(b"S", ns, key, tail)


def _fp_meta(ns: str, key: str, entries: Dict[str, bytes]) -> int:
    parts = [len(entries).to_bytes(4, "big")]
    for name in sorted(entries):
        for part in (name.encode(), entries[name]):
            parts.append(len(part).to_bytes(4, "big"))
            parts.append(part)
    return _fp_entry(b"M", ns, key, b"".join(parts))


class KvLedger:
    """One channel's ledger, in memory."""

    def __init__(self, ledger_id: str = "ch"):
        self.ledger_id = ledger_id
        self.state = VersionedDB()
        self._blocks: List[m.Block] = []
        self._txids: set = set()
        self._last_hash = b""
        self._lock = threading.Lock()

    @property
    def height(self) -> int:
        return len(self._blocks)

    def tx_id_exists(self, txid: str) -> bool:
        return txid in self._txids

    def commit_block(self, block: m.Block,
                     incoming_flags: Optional[List[int]] = None) -> List[int]:
        """MVCC-validate + commit a block whose signature/policy
        verdicts are `incoming_flags` (defaults to the flags already in
        the block metadata).  Returns the final flags."""
        with self._lock:
            num = block.header.number
            if num != self.height:
                raise LedgerError(
                    f"commit out of order: {num} at height {self.height}")
            if num > 0 and block.header.previous_hash != self._last_hash:
                raise LedgerError(f"block {num} previous_hash mismatch")
            envs = protoutil.get_envelopes(block)
            if incoming_flags is None:
                # fail closed: absent metadata flags decode to
                # NOT_VALIDATED, never to VALID
                incoming_flags = list(protoutil.block_txflags(block))
            elif len(incoming_flags) != len(envs):
                raise LedgerError(
                    f"flags length {len(incoming_flags)} != "
                    f"{len(envs)} txs")
            txs = []
            txids = []
            for env, flag in zip(envs, incoming_flags):
                try:
                    ch = protoutil.envelope_channel_header(env)
                except Exception:
                    txs.append(("", None, m.TxValidationCode.BAD_PAYLOAD))
                    txids.append("")
                    continue
                txids.append(ch.tx_id)
                if ch.type != m.HeaderType.ENDORSER_TRANSACTION:
                    # config/control txs commit with no state effects
                    txs.append((ch.tx_id, m.TxReadWriteSet(), flag))
                else:
                    txs.append((ch.tx_id, tx_rwset_from_envelope(env), flag))
            flags, batch, _tx_writes = validate_and_prepare_batch(
                txs, self.state, num)
            protoutil.set_block_txflags(block, bytes(flags))
            self._blocks.append(block)
            self._txids.update(t for t in txids if t)
            self._last_hash = protoutil.block_header_hash(block.header)
            self.state.apply_updates(batch, num)
        return flags

    def state_fingerprint(self) -> str:
        """Digest of the entire committed state — every (ns, key,
        value, version) row, every key-metadata entry, and the chain
        height — equal to the reference ledger's for the same blocks
        and flags.  Taken under the commit lock."""
        with self._lock:
            acc = 0
            for ns, key, value, ver in self.state.iter_state():
                acc ^= _fp_row(ns, key, value, ver)
            for ns, key, entries in self.state.iter_metadata():
                acc ^= _fp_meta(ns, key, entries)
            h = hashlib.sha256(self.height.to_bytes(8, "big"))
            h.update(acc.to_bytes(32, "big"))
            return h.hexdigest()
