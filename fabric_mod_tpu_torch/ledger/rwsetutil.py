"""Read-write set building and parsing — the port's copy of
fabric_mod_tpu/ledger/rwsetutil.py (reference: core/ledger/kvledger/
txmgmt/rwsetutil/rwset_builder.go and rwset_proto_util.go), with the
private-data half: a private write's plaintext goes to the
TxPvtReadWriteSet the endorser stages (`build_pvt`), its sha256 key and
value hashes into the public rwset's hashed collection section.

Range-query results are fingerprinted with a running SHA-256 over the
sorted (key, version) pairs; MVCC phantom detection re-executes the
range at validation time and compares fingerprints.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.ledger.pvtdata import hash_key, hash_value
from fabric_mod_tpu_torch.protos import messages as m

Version = Tuple[int, int]


def version_proto(v: Optional[Version]) -> Optional[m.Version]:
    if v is None:
        return None
    return m.Version(block_num=v[0], tx_num=v[1])


def version_tuple(v: Optional[m.Version]) -> Optional[Version]:
    if v is None:
        return None
    return (v.block_num, v.tx_num)


def range_fingerprint(results: List[Tuple[str, Version]]) -> bytes:
    """Deterministic digest of a range-query result set."""
    h = hashlib.sha256()
    for key, ver in results:
        kb = key.encode()
        h.update(len(kb).to_bytes(4, "big"))
        h.update(kb)
        h.update(ver[0].to_bytes(8, "big"))
        h.update(ver[1].to_bytes(8, "big"))
    return h.digest()


class RWSetBuilder:
    """Collects one transaction's simulation effects."""

    def __init__(self):
        self._reads: Dict[str, Dict[str, Optional[Version]]] = {}
        self._writes: Dict[str, Dict[str, Optional[bytes]]] = {}
        self._ranges: Dict[str, List[m.RangeQueryInfo]] = {}
        self._meta: Dict[str, Dict[str, Dict[str, bytes]]] = {}
        self._pvt: Dict[Tuple[str, str], Dict[str, Optional[bytes]]] = {}

    def add_read(self, ns: str, key: str, version: Optional[Version]) -> None:
        self._reads.setdefault(ns, {}).setdefault(key, version)

    def add_write(self, ns: str, key: str, value: Optional[bytes]) -> None:
        self._writes.setdefault(ns, {})[key] = value

    def add_metadata_write(self, ns: str, key: str, name: str,
                           value: bytes) -> None:
        """(reference: rwset_builder.go AddToMetadataWriteSet — key
        metadata like the VALIDATION_PARAMETER endorsement override)"""
        self._meta.setdefault(ns, {}).setdefault(key, {})[name] = value

    def add_pvt_write(self, ns: str, collection: str, key: str,
                      value: Optional[bytes]) -> None:
        """A private write (None deletes): plaintext into the pvt
        rwset, hashes into the public rwset (reference: rwset_builder.go's
        pvt/hashed bookkeeping)."""
        self._pvt.setdefault((ns, collection), {})[key] = value

    def build_pvt(self) -> Optional[m.TxPvtReadWriteSet]:
        """The plaintext private write sets the endorser stages into the
        transient store; None without private writes."""
        if not self._pvt:
            return None
        by_ns: Dict[str, List[m.CollectionPvtReadWriteSet]] = {}
        for (ns, coll), writes in sorted(self._pvt.items()):
            kv = m.KVRWSet(writes=[
                m.KVWrite(key=k, is_delete=int(v is None), value=v or b"")
                for k, v in sorted(writes.items())])
            by_ns.setdefault(ns, []).append(
                m.CollectionPvtReadWriteSet(collection_name=coll,
                                            rwset=kv.encode()))
        return m.TxPvtReadWriteSet(ns_pvt_rwset=[
            m.NsPvtReadWriteSet(namespace=ns, collection_pvt_rwset=colls)
            for ns, colls in sorted(by_ns.items())])

    def add_range_query(self, ns: str, start: str, end: str,
                        exhausted: bool,
                        results: List[Tuple[str, Version]]) -> None:
        self._ranges.setdefault(ns, []).append(m.RangeQueryInfo(
            start_key=start, end_key=end, itr_exhausted=int(exhausted),
            reads_merkle_hash=range_fingerprint(results)))

    def build(self) -> m.TxReadWriteSet:
        hashed_by_ns: Dict[str, List[m.CollectionHashedReadWriteSet]] = {}
        for (ns, coll), writes in sorted(self._pvt.items()):
            hset = m.HashedRWSet(hashed_writes=[
                m.KVWriteHash(key_hash=hash_key(k),
                              is_delete=int(v is None),
                              value_hash=b"" if v is None
                              else hash_value(v))
                for k, v in sorted(writes.items())])
            hashed_by_ns.setdefault(ns, []).append(
                m.CollectionHashedReadWriteSet(
                    collection_name=coll, hashed_rwset=hset.encode()))
        ns_sets = []
        for ns in sorted(set(self._reads) | set(self._writes)
                         | set(self._ranges) | set(self._meta)
                         | set(hashed_by_ns)):
            kv = m.KVRWSet(
                reads=[m.KVRead(key=k, version=version_proto(v))
                       for k, v in sorted(
                           self._reads.get(ns, {}).items())],
                range_queries_info=self._ranges.get(ns, []),
                writes=[m.KVWrite(key=k,
                                  is_delete=int(val is None),
                                  value=val or b"")
                        for k, val in sorted(
                            self._writes.get(ns, {}).items())],
                metadata_writes=[
                    m.KVMetadataWrite(key=k, entries=[
                        m.KVMetadataEntry(name=n, value=v)
                        for n, v in sorted(entries.items())])
                    for k, entries in sorted(
                        self._meta.get(ns, {}).items())])
            ns_sets.append(m.NsReadWriteSet(
                namespace=ns, rwset=kv.encode(),
                collection_hashed_rwset=hashed_by_ns.get(ns, [])))
        return m.TxReadWriteSet(data_model=0, ns_rwset=ns_sets)


def parse_tx_rwset(rwset: m.TxReadWriteSet) -> List[Tuple[str, m.KVRWSet]]:
    return [(ns.namespace, m.KVRWSet.decode(ns.rwset))
            for ns in rwset.ns_rwset]
