"""Signed gossip message helpers.

The port's copy of fabric_mod_tpu/gossip/protoext.py (reference:
gossip/protoext/signing.go:209 — every gossip message travels as an
envelope whose payload is signed by the sender and verified against the
sender's identity).
"""
from __future__ import annotations

from typing import Callable, Optional

from fabric_mod_tpu_torch.protos import messages as m


def sign_message(msg: m.GossipMessage, signer) -> m.GossipEnvelope:
    payload = msg.encode()
    return m.GossipEnvelope(payload=payload,
                            signature=signer.sign_message(payload))


def verify_envelope(env: m.GossipEnvelope,
                    verify: Callable[[bytes, bytes], bool]
                    ) -> Optional[m.GossipMessage]:
    """The decoded message if `verify(payload, signature)` holds, else
    None (fail-closed).  A payload that does not decode is a rejection;
    whatever `verify` raises propagates."""
    if not env.payload or not env.signature:
        return None
    if not verify(env.payload, env.signature):
        return None
    try:
        return m.GossipMessage.decode(env.payload)
    except ValueError:
        return None
