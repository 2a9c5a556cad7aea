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
then re-raises it (reference :84-89, :140-153).

Overload (orderer/admission.py): with an `AdmissionController` that has
a mechanism on, `submit` classifies the envelope (one header parse) and
consults the controller BEFORE the processor's signature work: the
per-client token buckets and the occupancy/latency gate shed normal txs
with the typed, retryable ResourceExhaustedError, while config and
lifecycle traffic always passes; the latency of an ACCEPTED submission
(route, admit, processor, enqueue) feeds the controller (reference
:75-162).  Without one, the path is one None check.  A submission is
the "broadcast.submit" span (tracer armed).
"""
from __future__ import annotations

import time

from fabric_mod_tpu_torch.channelconfig import ConfigTxError
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.orderer import admission as admission_mod
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
    0 runs each submitter's check on its own thread.  `admission`: an
    admission_mod.AdmissionController (None, or one with every
    mechanism off, admits everything as the default ingress does)."""

    def __init__(self, registrar: Registrar, staged_batch: int = 0,
                 admission=None):
        if staged_batch < 0:
            raise ValueError("staged_batch must be >= 0")
        self._registrar = registrar
        self._staged = StagedIngress(staged_batch) if staged_batch else None
        self._admission = (admission if admission is not None
                           and admission.enabled else None)

    @property
    def admission(self):
        """The controller consulted on each submission, or None."""
        return self._admission

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
        no leader within the retry budget, and
        admission_mod.ResourceExhaustedError when admission sheds it."""
        with tracing.span("broadcast.submit"):
            self._submit(env)

    def _submit(self, env: m.Envelope) -> None:
        adm = self._admission
        t0 = time.perf_counter() if adm is not None else 0.0
        try:
            support, is_config_update = \
                self._registrar.broadcast_channel_support(env)
        except Exception as e:
            raise BroadcastError(f"routing: {e}") from e
        if adm is not None:
            # before the processor: a shed costs one header parse, not
            # a signature check; the gate is per channel
            client, priority = admission_mod.classify(
                env, is_config_update, need_client=adm.has_limiter)
            adm.admit(client, priority,
                      admission_mod.chain_occupancy(support.chain),
                      channel=support.channel_id)
        if is_config_update:
            try:
                wrapped, seq = \
                    support.processor.process_config_update_msg(env)
                # a consenter's pre-order check (Raft's one-membership-
                # change rule) is a client fault too
                self._retry_not_leader(support.chain.configure, wrapped, seq)
            except _CLIENT_FAULTS as e:
                raise BroadcastError(f"config update rejected: {e}") from e
            self._note_latency(support, t0)
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
        self._note_latency(support, t0)

    def _note_latency(self, support, t0: float) -> None:
        """Accepted-path latency only: a shed raised before this, and
        shed latencies in the EWMA would let fast rejections close the
        gate they caused."""
        if self._admission is not None:
            self._admission.note_latency(time.perf_counter() - t0,
                                         channel=support.channel_id)
