"""Gossip identity mapper: PKI-ID <-> certificate store.

The port's copy of fabric_mod_tpu/gossip/identity.py (reference:
gossip/identity/identity.go — Mapper with Put/Get/Sign/Verify at :176
and the expiry-based purge SuspectPeers at :190).

The PKI-ID is the SHA-256 of the serialized identity; verification goes
through the channel's batch verifier as a one-item `verify_many`, so on
a card every gossip envelope's signature is a device check.  Only the
MSP's rejections of an identity are answered False here: whatever the
verifier raises propagates.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional

from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.msp.mspimpl import MSPValidationError

# what deserializing or validating an identity raises for one the MSP
# rejects or cannot parse
IDENTITY_REJECTED = (MSPValidationError, ValueError)


def pki_id_of(serialized_identity: bytes) -> bytes:
    return hashlib.sha256(serialized_identity).digest()


class IdentityMapper:
    def __init__(self, msp_mgr, verifier=None):
        self._msp = msp_mgr
        self._verifier = verifier
        self._lock = RegisteredLock("gossip.identity._lock")
        self._store: Dict[bytes, bytes] = {}    # pki_id -> serialized

    def put(self, serialized_identity: bytes) -> bytes:
        """Validate and store; returns the PKI-ID.  Raises on identities
        the MSP rejects (reference: identity.go Put)."""
        ident = self._msp.deserialize_identity(serialized_identity)
        self._msp.validate(ident)
        pid = pki_id_of(serialized_identity)
        with self._lock:
            self._store[pid] = serialized_identity
        return pid

    def get(self, pki_id: bytes) -> Optional[bytes]:
        with self._lock:
            return self._store.get(pki_id)

    def verify(self, pki_id: bytes, msg: bytes, sig: bytes) -> bool:
        """(reference: identity.go:176 Verify)"""
        raw = self.get(pki_id)
        if raw is None:
            return False
        try:
            ident = self._msp.deserialize_identity(raw)
        except IDENTITY_REJECTED:
            return False
        if self._verifier is not None:
            item = ident.verify_item(msg, sig)
            if item is not None:
                return bool(self._verifier.verify_many([item])[0])
        return ident.verify(msg, sig)

    def suspect_peers(self, is_suspected: Callable[[bytes], bool]) -> None:
        """Re-validate suspected identities, dropping the ones the MSP
        no longer accepts (reference: identity.go:190 SuspectPeers)."""
        with self._lock:
            items = list(self._store.items())
        for pid, raw in items:
            if not is_suspected(raw):
                continue
            try:
                ident = self._msp.deserialize_identity(raw)
                self._msp.validate(ident)
            except IDENTITY_REJECTED:
                with self._lock:
                    self._store.pop(pid, None)
