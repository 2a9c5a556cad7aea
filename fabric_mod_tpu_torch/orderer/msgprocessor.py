"""Orderer ingress message processing.

The port's copy of fabric_mod_tpu/orderer/msgprocessor.py
`StandardChannelProcessor` (:33; reference: orderer/common/msgprocessor
— StandardChannel at standardchannel.go:70 with its filter chain,
SigFilter.Apply at sigfilter.go:41, and ProcessConfigUpdateMsg).

The filters reject empty envelopes, enforce the channel's
absolute_max_bytes, and require the channel Writers policy over the
envelope's signature.  The Writers check verifies on the host, as the
reference's Network builds it by default: one envelope is one
signature, and a device call per envelope would cost its fixed launch
overhead every time.  The reference's `verify_many` seam and its
batched `process_normal_msgs` (the staged-broadcast path) are not
ported.
"""
from __future__ import annotations

from typing import Callable, Tuple

from fabric_mod_tpu_torch.channelconfig import (
    extract_config_update, propose_config_update)
from fabric_mod_tpu_torch.channelconfig.bundle import Bundle
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


class MsgRejectedError(Exception):
    pass


CHANNEL_WRITERS = "/Channel/Writers"


class StandardChannelProcessor:
    """Per-channel ingress processor.  `bundle_fn` returns the CURRENT
    bundle, so every message is judged under the config in force when
    it is processed."""

    def __init__(self, bundle_fn: Callable[[], Bundle],
                 signer=None):
        self._bundle = bundle_fn
        self._signer = signer          # orderer identity for CONFIG wraps

    def _apply_filters(self, env: m.Envelope, bundle: Bundle) -> None:
        if not env.payload:
            raise MsgRejectedError("empty envelope")
        oc = bundle.orderer
        if oc is not None and len(env.encode()) > \
                oc.batch_size.absolute_max_bytes:
            raise MsgRejectedError("message exceeds absolute_max_bytes")
        pol = bundle.policy(CHANNEL_WRITERS)
        if pol is None:
            raise MsgRejectedError(f"no {CHANNEL_WRITERS} policy")
        sds = protoutil.envelope_as_signed_data(env)
        if not pol.evaluate_signed_data(sds):
            raise MsgRejectedError("signature does not satisfy Writers")

    def process_normal_msg(self, env: m.Envelope) -> int:
        """Validate a normal tx for ordering; returns the config
        sequence it was validated under (reference: standardchannel.go
        ProcessNormalMsg)."""
        bundle = self._bundle()
        ch = protoutil.envelope_channel_header(env)
        if ch.channel_id != bundle.channel_id:
            raise MsgRejectedError(
                f"message for channel {ch.channel_id!r} on "
                f"{bundle.channel_id!r}")
        self._apply_filters(env, bundle)
        return bundle.sequence

    def process_config_update_msg(
            self, env: m.Envelope) -> Tuple[m.Envelope, int]:
        """CONFIG_UPDATE -> validated CONFIG envelope ready to order
        (reference: standardchannel.go ProcessConfigUpdateMsg: filters,
        ProposeConfigUpdate, wrap)."""
        bundle = self._bundle()
        self._apply_filters(env, bundle)
        cue = extract_config_update(env)
        new_config = propose_config_update(bundle, cue)
        cenv = m.ConfigEnvelope(config=new_config, last_update=env)
        ch = protoutil.make_channel_header(m.HeaderType.CONFIG,
                                           bundle.channel_id)
        if self._signer is not None:
            sh = protoutil.make_signature_header(
                self._signer.serialize(), protoutil.new_nonce())
            payload = protoutil.make_payload(ch, sh, cenv.encode())
            wrapped = protoutil.sign_envelope(payload, self._signer)
        else:
            sh = protoutil.make_signature_header(b"", protoutil.new_nonce())
            payload = protoutil.make_payload(ch, sh, cenv.encode())
            wrapped = m.Envelope(payload=payload.encode())
        return wrapped, bundle.sequence
