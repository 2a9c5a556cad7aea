"""Broadcast ingress: envelope in, routed + validated + ordered.

The port's copy of fabric_mod_tpu/orderer/broadcast.py `Broadcast.submit`
(:104; reference: orderer/common/broadcast/broadcast.go — Handle :66,
ProcessMessage :136-180: classify -> msgprocessor -> WaitReady ->
Order/Configure).  `submit` is the unary form of one stream message.

Unstaged, as the reference runs by default: each submitter's Writers
check runs on its own thread.  Not ported: the admission gate, the
staged lanes that coalesce concurrent submitters into one batched
verify, and the NOT_LEADER retrier (solo always has a leader).
"""
from __future__ import annotations

from fabric_mod_tpu_torch.channelconfig import ConfigTxError
from fabric_mod_tpu_torch.orderer.msgprocessor import MsgRejectedError
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.protos import messages as m

# client-attributable rejections -> BAD_REQUEST on the wire; anything
# else propagates as an internal error
_CLIENT_FAULTS = (MsgRejectedError, ConfigTxError, ValueError)


class BroadcastError(Exception):
    pass


class Broadcast:
    def __init__(self, registrar: Registrar):
        self._registrar = registrar

    def submit(self, env: m.Envelope) -> None:
        """Accept one envelope for ordering; raises BroadcastError on a
        client-caused rejection."""
        try:
            support, is_config_update = \
                self._registrar.broadcast_channel_support(env)
        except Exception as e:
            raise BroadcastError(f"routing: {e}") from e
        if is_config_update:
            try:
                wrapped, seq = \
                    support.processor.process_config_update_msg(env)
            except _CLIENT_FAULTS as e:
                raise BroadcastError(f"config update rejected: {e}") from e
            support.chain.configure(wrapped, seq)
            return
        try:
            seq = support.processor.process_normal_msg(env)
        except _CLIENT_FAULTS as e:
            raise BroadcastError(f"rejected: {e}") from e
        support.chain.order(env, seq)
