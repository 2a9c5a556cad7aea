"""Orderer ingress message processing.

The port's copy of fabric_mod_tpu/orderer/msgprocessor.py
`StandardChannelProcessor` (:33; reference: orderer/common/msgprocessor
— StandardChannel at standardchannel.go:70 with its filter chain,
SigFilter.Apply at sigfilter.go:41, and ProcessConfigUpdateMsg).

The filters reject empty envelopes, enforce the channel's
absolute_max_bytes, and require the channel Writers policy over the
envelope's signature.  The Writers check verifies through the
`verify_many` seam (reference :40): None verifies on the host, as the
reference's Network builds it by default; with ingress batching the
Network passes a `BatchingVerifyService`'s, so the check rides a device
batch.  `process_normal_msgs` (reference :79) is the batched form the
staged lanes call (orderer/stagedbroadcast.py): one bundle read and ONE
`verify_many` call for a whole cohort, a typed verdict per slot.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from fabric_mod_tpu_torch.channelconfig import (
    extract_config_update, propose_config_update)
from fabric_mod_tpu_torch.channelconfig.bundle import Bundle
from fabric_mod_tpu_torch.policy.cauthdsl import BatchCollector
from fabric_mod_tpu_torch.policy.manager import batch_verifier
from fabric_mod_tpu_torch.protos import messages as m
from fabric_mod_tpu_torch.protos import protoutil


class MsgRejectedError(Exception):
    pass


CHANNEL_WRITERS = "/Channel/Writers"
_WRITERS_FAILED = "signature does not satisfy Writers"


class StandardChannelProcessor:
    """Per-channel ingress processor.  `bundle_fn` returns the CURRENT
    bundle, so every message is judged under the config in force when
    it is processed.  `verify_many`: the Writers and config-update
    policy checks' verifier (None: the host)."""

    def __init__(self, bundle_fn: Callable[[], Bundle],
                 signer=None, verify_many: Optional[Callable] = None):
        self._bundle = bundle_fn
        self._signer = signer          # orderer identity for CONFIG wraps
        self._verify_many = verify_many

    @staticmethod
    def _check_channel(env: m.Envelope, bundle: Bundle) -> None:
        ch = protoutil.envelope_channel_header(env)
        if ch.channel_id != bundle.channel_id:
            raise MsgRejectedError(
                f"message for channel {ch.channel_id!r} on "
                f"{bundle.channel_id!r}")

    @staticmethod
    def _check(env: m.Envelope, bundle: Bundle):
        """The filters before the signature check; returns the Writers
        policy."""
        if not env.payload:
            raise MsgRejectedError("empty envelope")
        oc = bundle.orderer
        if oc is not None and len(env.encode()) > \
                oc.batch_size.absolute_max_bytes:
            raise MsgRejectedError("message exceeds absolute_max_bytes")
        pol = bundle.policy(CHANNEL_WRITERS)
        if pol is None:
            raise MsgRejectedError(f"no {CHANNEL_WRITERS} policy")
        return pol

    def _apply_filters(self, env: m.Envelope, bundle: Bundle) -> None:
        pol = self._check(env, bundle)
        sds = protoutil.envelope_as_signed_data(env)
        if not pol.evaluate_signed_data(sds, self._verify_many):
            raise MsgRejectedError(_WRITERS_FAILED)

    def process_normal_msg(self, env: m.Envelope) -> int:
        """Validate a normal tx for ordering; returns the config
        sequence it was validated under (reference: standardchannel.go
        ProcessNormalMsg)."""
        bundle = self._bundle()
        self._check_channel(env, bundle)
        self._apply_filters(env, bundle)
        return bundle.sequence

    def process_normal_msgs(self, envs: Sequence[m.Envelope]) -> List[object]:
        """Batched `process_normal_msg`: many normal txs under ONE bundle
        read, their Writers signature checks in ONE `verify_many` call.
        One verdict per envelope, in order: the config sequence (int) on
        acceptance, the exception on rejection — a bad envelope costs
        its own slot only.  If the batch call itself raises, each
        envelope is judged again alone through the same seam, so a
        fault costs its own envelope, never its batch-mates."""
        bundle = self._bundle()
        results: List[object] = [None] * len(envs)
        collector = BatchCollector()
        pol = None
        staged = []                          # (slot, pending evaluation)
        for i, env in enumerate(envs):
            try:
                self._check_channel(env, bundle)
                pol = self._check(env, bundle)
                sds = protoutil.envelope_as_signed_data(env)
                staged.append((i, pol.prepare(sds, collector)))
            except Exception as e:           # the slot's typed verdict
                results[i] = e
        if not staged:
            return results
        try:
            mask = batch_verifier(pol, self._verify_many)(collector.items)
            verdicts = [(i, p.finish(mask)) for i, p in staged]
        except Exception:                    # the batch call's fault
            for i, _ in staged:
                try:
                    results[i] = self.process_normal_msg(envs[i])
                except Exception as e:       # the slot's verdict
                    results[i] = e
            return results
        for i, ok in verdicts:
            results[i] = bundle.sequence if ok else MsgRejectedError(
                _WRITERS_FAILED)
        return results

    def process_config_update_msg(
            self, env: m.Envelope) -> Tuple[m.Envelope, int]:
        """CONFIG_UPDATE -> validated CONFIG envelope ready to order
        (reference: standardchannel.go ProcessConfigUpdateMsg: filters,
        ProposeConfigUpdate, wrap)."""
        bundle = self._bundle()
        self._apply_filters(env, bundle)
        cue = extract_config_update(env)
        new_config = propose_config_update(bundle, cue, self._verify_many)
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
