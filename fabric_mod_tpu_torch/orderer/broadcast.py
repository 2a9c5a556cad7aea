"""Broadcast ingress: envelope in, routed + validated + ordered.

The port's copy of fabric_mod_tpu/orderer/broadcast.py `Broadcast.submit`
(:104; reference: orderer/common/broadcast/broadcast.go — Handle :66,
ProcessMessage :136-180: classify -> msgprocessor -> WaitReady ->
Order/Configure).  `submit` is the unary form of one stream message.

Unstaged (`staged_batch=0`, the reference's default), each submitter's
Writers check runs on its own thread.  Staged (`staged_batch` > 0,
reference :94-102, :146-153), concurrent submitters' normal txs go
through the per-channel lanes of orderer/stagedbroadcast.py, which
judge each cohort with one batched `verify_many` call; the verdict comes
back to the submitter's thread, and `chain.order` stays there.  Config
updates always take the blocking path.

A Raft consenter with no leader to forward to raises the typed
NotLeaderError; `submit` retries it with a backoff (0.05 s doubling to
0.5 s) for up to NOT_LEADER_RETRY_S, the reference's default budget,
then re-raises it (reference :84-89, :140-153).  Not ported: the
admission gate.
"""
from __future__ import annotations

import time

from fabric_mod_tpu_torch.channelconfig import ConfigTxError
from fabric_mod_tpu_torch.orderer.consensus import NotLeaderError
from fabric_mod_tpu_torch.orderer.msgprocessor import MsgRejectedError
from fabric_mod_tpu_torch.orderer.registrar import Registrar
from fabric_mod_tpu_torch.orderer.stagedbroadcast import StagedIngress
from fabric_mod_tpu_torch.protos import messages as m

# client-attributable rejections -> BAD_REQUEST on the wire; anything
# else propagates as an internal error
_CLIENT_FAULTS = (MsgRejectedError, ConfigTxError, ValueError)
NOT_LEADER_RETRY_S = 5.0


class BroadcastError(Exception):
    pass


class Broadcast:
    """`staged_batch`: the most envelopes one lane drain judges together;
    0 runs each submitter's check on its own thread."""

    def __init__(self, registrar: Registrar, staged_batch: int = 0):
        if staged_batch < 0:
            raise ValueError("staged_batch must be >= 0")
        self._registrar = registrar
        self._staged = StagedIngress(staged_batch) if staged_batch else None

    @staticmethod
    def _retry_not_leader(fn, *args) -> None:
        deadline = time.monotonic() + NOT_LEADER_RETRY_S
        pause = 0.05
        while True:
            try:
                return fn(*args)
            except NotLeaderError:
                if time.monotonic() + pause > deadline:
                    raise
            time.sleep(pause)
            pause = min(0.5, 2 * pause)

    def close(self) -> None:
        """Stop the lanes (nothing to stop unstaged); a submitter racing
        the close gets a typed error, never a hang."""
        if self._staged is not None:
            self._staged.close()

    def submit(self, env: m.Envelope) -> None:
        """Accept one envelope for ordering; raises BroadcastError on a
        client-caused rejection, NotLeaderError when the consenter found
        no leader within the retry budget."""
        try:
            support, is_config_update = \
                self._registrar.broadcast_channel_support(env)
        except Exception as e:
            raise BroadcastError(f"routing: {e}") from e
        if is_config_update:
            try:
                wrapped, seq = \
                    support.processor.process_config_update_msg(env)
                # a consenter's pre-order check (Raft's one-membership-
                # change rule) is a client fault too
                self._retry_not_leader(support.chain.configure, wrapped, seq)
            except _CLIENT_FAULTS as e:
                raise BroadcastError(f"config update rejected: {e}") from e
            return
        try:
            if self._staged is not None:
                seq = self._staged.submit(support.channel_id,
                                          support.processor, env)
            else:
                seq = support.processor.process_normal_msg(env)
        except _CLIENT_FAULTS as e:
            raise BroadcastError(f"rejected: {e}") from e
        self._retry_not_leader(support.chain.order, env, seq)
