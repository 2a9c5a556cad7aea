"""Second-chance caches around an MSP — the port's copy of
fabric_mod_tpu/msp/cache.py (reference: msp/cache/cache.go,
msp/cache/second_chance.go): repeated deserialize / validate /
satisfies-principal calls on hot identities are answered from memory.
"""
from __future__ import annotations

from typing import Any, Dict

from fabric_mod_tpu_torch.concurrency import RegisteredLock


class SecondChanceCache:
    """Clock (second-chance) eviction, thread-safe."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._lock = RegisteredLock("msp.cache._lock")
        self._data: Dict[Any, list] = {}    # key -> [value, referenced]
        self._ring: list = []
        self._hand = 0

    def get(self, key):
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                return None
            ent[1] = True
            return ent[0]

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._data:
                self._data[key][0] = value
                return
            while len(self._data) >= self.capacity:
                victim = self._ring[self._hand]
                ent = self._data.get(victim)
                if ent is not None and ent[1]:
                    ent[1] = False
                    self._hand = (self._hand + 1) % len(self._ring)
                    continue
                if ent is not None:
                    del self._data[victim]
                self._ring[self._hand] = key
                self._data[key] = [value, False]
                self._hand = (self._hand + 1) % len(self._ring)
                return
            self._ring.append(key)
            self._data[key] = [value, False]


class CachedMsp:
    """Wraps an Msp (or MspManager) with caches on the three hot calls
    (reference: msp/cache/cache.go:42-49)."""

    def __init__(self, msp, capacity: int = 256):
        self._msp = msp
        self._deser = SecondChanceCache(capacity)
        self._valid = SecondChanceCache(capacity)
        self._princ = SecondChanceCache(capacity)

    def __getattr__(self, name):
        return getattr(self._msp, name)

    def deserialize_identity(self, serialized: bytes):
        hit = self._deser.get(serialized)
        if hit is not None:
            return hit
        ident = self._msp.deserialize_identity(serialized)
        self._deser.put(serialized, ident)
        return ident

    def validate(self, ident) -> None:
        key = ident.serialize()
        cached = self._valid.get(key)
        if cached is True:
            return
        if isinstance(cached, Exception):
            raise cached
        try:
            self._msp.validate(ident)
        except Exception as e:
            self._valid.put(key, e)
            raise
        self._valid.put(key, True)

    def satisfies_principal(self, ident, principal) -> bool:
        key = (ident.serialize(), principal.encode())
        cached = self._princ.get(key)
        if cached is not None:
            return cached
        out = self._msp.satisfies_principal(ident, principal)
        self._princ.put(key, out)
        return out
