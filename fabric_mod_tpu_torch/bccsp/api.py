"""The verify work item — the port's copy of fabric_mod_tpu/bccsp/api.py's
`VerifyItem` (the rest of that module, the BCCSP provider interface, is
host-side and not ported in this slice)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VerifyItem:
    """One signature-verification work item (the batch element).

    digest: 32-byte message digest (pre-hashed).  Ignored (use b"")
      when `message` is set.
    signature: DER-encoded ECDSA signature.
    public_xy: 64 bytes — uncompressed P-256 point coordinates (x‖y).
    message: optional RAW message bytes.  When set, the provider
      computes e = SHA-256(message) itself, on the device, in the same
      program as the verify (ops/p256.batch_verify_raw).  Raw and
      pre-digested items mix freely in one batch.
    """
    digest: bytes
    signature: bytes
    public_xy: bytes
    message: Optional[bytes] = None
