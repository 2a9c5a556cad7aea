"""Admission control and backpressure for the orderer ingress.

The port's copy of fabric_mod_tpu/orderer/admission.py (reference:
orderer/common/broadcast's WaitReady flow control, broadcast.go:166, and
etcdraft's Submit path, which answers SERVICE_UNAVAILABLE instead of
wedging; this module generalizes that into typed shedding: a burst from
many clients costs `RESOURCE_EXHAUSTED + retry-after` answers, never a
wedged node or a silently growing queue).

Three cooperating mechanisms, all dark unless an `AdmissionController`
is built with one of them on (`enabled`), so a default deployment keeps
the blocking 10,000-entry queue and no limiter or gate:

* **Bounded submit queues** (`queue_cap` > 0, the chains' own argument,
  threaded by the registrar and e2e.Network): SoloChain and RaftChain
  switch from blocking puts to bounded non-blocking puts; a full queue
  answers the typed, retryable `ResourceExhaustedError`
  (reason="queue_full").  Config and other priority txs keep a blocking
  put.

* **Per-client token buckets** (`rate` > 0, `burst`): each client
  identity (a hash of the envelope's creator) draws from its own bucket;
  an empty bucket sheds with reason="rate_limited" and a retry-after of
  the real token deficit.  The client table is bounded (LRU), and
  first-seen clients also draw from one shared newcomers bucket.

* **Overload gate** (`shed_high` / `shed_low` watermarks over the
  submit queue's occupancy and an EWMA of admission latency,
  `shed_lat_s`): opens at the high watermark (or when the latency EWMA
  crosses the threshold), sheds NORMAL txs with reason="overloaded",
  and closes only back at the low watermark.  Config and lifecycle txs
  are always admitted.

The reference reads these settings from environment knobs (its :72-110);
here they are `AdmissionController`'s constructor arguments with the
reference's defaults, "every knob unset".  Shed accounting rides the
metrics registry (observability/metrics.py): queue occupancy, sheds by
reason, throttles, throttled clients, gate state, the admission-latency
histogram and the chains' drop counter, under the reference's names.

The fault point `orderer.admission.overload` in drop mode forces the
gate open for that pass (reason="forced"), as the reference's does.
"""
from __future__ import annotations

import functools
import hashlib
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from fabric_mod_tpu_torch import faults
from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.observability import tracing
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)

DEFAULT_SHED_HIGH = 0.9
DEFAULT_SHED_LOW = 0.6


def default_burst(rate: float) -> float:
    """The bucket capacity when none is given: 2x the rate, floor 1
    (the reference's burst knob default)."""
    return max(1.0, 2.0 * rate)


def enabled(queue_cap: int = 0, rate: float = 0.0,
            shed_lat_s: float = 0.0) -> bool:
    """Is any admission mechanism on?  False: the default ingress,
    untouched (reference :107)."""
    return queue_cap > 0 or rate > 0.0 or shed_lat_s > 0.0


# ---------------------------------------------------------------------------
# metrics (get-or-create: chains/controllers instantiate many times)
# ---------------------------------------------------------------------------

_OCCUPANCY_OPTS = MetricOpts(
    "fabric", "orderer", "submit_queue_occupancy",
    help="Consenter submit-queue occupancy fraction (qsize/maxsize) "
         "observed at the last admission decision, per channel.",
    label_names=("channel",))
_SHEDS_OPTS = MetricOpts(
    "fabric", "orderer", "admission_sheds_total",
    help="Submissions shed by admission control, per reason "
         "(rate_limited | overloaded | queue_full | forced).",
    label_names=("reason",))
_THROTTLES_OPTS = MetricOpts(
    "fabric", "orderer", "admission_throttles_total",
    help="Per-client rate-limit rejections, totalled (the per-client "
         "split lives on the bounded limiter table, not labels).")
_THROTTLED_CLIENTS_OPTS = MetricOpts(
    "fabric", "orderer", "admission_throttled_clients",
    help="Distinct clients with at least one rate-limit rejection "
         "still resident in the (bounded) limiter table.")
_GATE_OPTS = MetricOpts(
    "fabric", "orderer", "overload_gate_open",
    help="1 while a channel's overload gate is shedding normal txs, "
         "else 0.",
    label_names=("channel",))
_LATENCY_OPTS = MetricOpts(
    "fabric", "orderer", "admission_latency_seconds",
    help="Broadcast admission latency: route + admit + processor + "
         "enqueue, per accepted submission.")
_CHAIN_DROPS_OPTS = MetricOpts(
    "fabric", "orderer", "chain_msgs_dropped_total",
    help="Chain-level messages dropped on a full queue, per path "
         "(forward = follower->leader submits, requeue = leadership-"
         "loss reproposals, raft_msg = raft FSM ingress).",
    label_names=("path",))


@functools.lru_cache(maxsize=None)
def _metrics():
    prov = default_provider()
    return {
        "occupancy": prov.gauge(_OCCUPANCY_OPTS),
        "sheds": prov.counter(_SHEDS_OPTS),
        "throttles": prov.counter(_THROTTLES_OPTS),
        "throttled_clients": prov.gauge(_THROTTLED_CLIENTS_OPTS),
        "gate": prov.gauge(_GATE_OPTS),
        "latency": prov.histogram(_LATENCY_OPTS),
    }


@functools.lru_cache(maxsize=None)
def chain_drop_counter():
    """Shared drop counter for chain/raft queue overflows (the
    satellite observability for what used to be silent `queue.Full`
    passes)."""
    return default_provider().counter(_CHAIN_DROPS_OPTS)


# ---------------------------------------------------------------------------
# the typed shed answer
# ---------------------------------------------------------------------------


class ResourceExhaustedError(Exception):
    """The ingress shed this submission: retryable by construction.

    `retry_after_s` is the server's hint for when a retry can succeed
    (the real token deficit for rate limits, a drain estimate for
    queue/overload sheds); the gRPC surface serializes it so remote
    clients back off exactly that long instead of guessing.  `reason`
    is the shed class the metrics count: "rate_limited", "overloaded",
    "queue_full" (and, in the reference, "forced")."""

    def __init__(self, msg: str, reason: str = "overloaded",
                 retry_after_s: float = 0.25):
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = retry_after_s


def shed(reason: str, msg: str,
         retry_after_s: float = 0.25) -> ResourceExhaustedError:
    """Count one shed and build the typed answer (callers raise it).
    Centralized so every shed — controller or chain queue — lands in
    the same counter (and, tracer armed, the flight recorder's event
    tape, next to the block timelines it interleaved with)."""
    _metrics()["sheds"].with_labels(reason).add(1)
    tracing.note_event("admission_shed", reason)
    return ResourceExhaustedError(msg, reason=reason,
                                  retry_after_s=retry_after_s)


# ---------------------------------------------------------------------------
# token bucket + per-client limiter
# ---------------------------------------------------------------------------


class TokenBucket:
    """Classic token bucket with an injectable clock.  Not
    thread-safe; the limiter serializes access."""

    __slots__ = ("rate", "burst", "tokens", "stamp", "throttles")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.stamp = now
        self.throttles = 0

    def try_take(self, now: float) -> float:
        """Take one token; returns 0.0 on success, else the seconds
        until a token accrues (the retry-after hint)."""
        if now > self.stamp:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        self.throttles += 1
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0


class ClientRateLimiter:
    """client key -> TokenBucket, bounded: least-recently-seen buckets
    are evicted at `max_clients` (an evicted client restarts with a
    full bucket — biased toward admitting, never toward wedging).

    The client key is the UNAUTHENTICATED creator (admission runs
    before the signature check, on purpose — shedding must be cheap),
    so a flood of forged, ever-fresh creators must not mint a fresh
    full bucket per envelope.  First-seen clients therefore ALSO draw
    from one shared "newcomers" bucket, sized `NEWCOMER_SCALE` x the
    per-client rate: invisible in normal operation, but a sybil burst
    drains it and gets rate_limited typed — and legitimately-new
    clients degrade the same bounded way while the burst lasts."""

    NEWCOMER_SCALE = 64

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=None, max_clients: int = 4096):
        self.rate = rate
        self.burst = burst if burst is not None else default_burst(rate)
        self._clock = clock or time
        self._max = max(1, max_clients)
        self._buckets: "OrderedDict[str, TokenBucket]" = OrderedDict()
        self._lock = RegisteredLock(
            "orderer.admission.ClientRateLimiter._lock")
        self._throttled = 0                # buckets with throttles > 0
        newcomer_rate = rate * self.NEWCOMER_SCALE
        self._newcomers = TokenBucket(
            newcomer_rate, max(self.burst, 2.0 * newcomer_rate),
            self._clock.monotonic())

    def admit(self, client: str) -> float:
        """0.0 = admitted; >0 = shed, retry after that many seconds."""
        now = self._clock.monotonic()
        with self._lock:
            bucket = self._buckets.get(client)
            if bucket is None:
                wait = self._newcomers.try_take(now)
                if wait > 0.0:
                    # forged-creator (or genuine thundering-herd)
                    # pressure: refuse to mint the bucket at all
                    _metrics()["throttles"].add(1)
                    return wait
                bucket = TokenBucket(self.rate, self.burst, now)
                self._buckets[client] = bucket
                while len(self._buckets) > self._max:
                    _key, gone = self._buckets.popitem(last=False)
                    if gone.throttles:
                        self._throttled -= 1
            else:
                self._buckets.move_to_end(client)
            wait = bucket.try_take(now)
            if wait > 0.0:
                if bucket.throttles == 1:
                    self._throttled += 1
                _metrics()["throttles"].add(1)
                _metrics()["throttled_clients"].set(self._throttled)
            return wait

    def throttles_by_client(self) -> Dict[str, int]:
        with self._lock:
            return {c: b.throttles for c, b in self._buckets.items()
                    if b.throttles}


# ---------------------------------------------------------------------------
# overload gate: occupancy watermarks + latency EWMA, with hysteresis
# ---------------------------------------------------------------------------


class OverloadGate:
    """Opens at `high` occupancy (or latency EWMA >= `lat_high_s`),
    closes at `low` — the hysteresis band keeps the gate from flapping
    when occupancy hovers at one watermark.  While open, NORMAL txs
    shed; config/lifecycle txs pass (the controller enforces that).

    The EWMA DECAYS over wall time (half-life `HALF_LIVES *
    lat_high_s`), not only on accepted samples: an open gate sheds the
    very traffic whose latencies would otherwise update the EWMA, so a
    sample-driven-only EWMA would latch a latency-opened gate open
    forever once the stall that caused it had passed.  The clock is
    injectable (ManualClock-testable)."""

    HALF_LIVES = 4.0                       # decay half-life factor

    def __init__(self, high: float = DEFAULT_SHED_HIGH,
                 low: float = DEFAULT_SHED_LOW,
                 lat_high_s: float = 0.0, ewma_alpha: float = 0.2,
                 clock=None, channel: str = ""):
        if low > high:
            raise ValueError("low watermark above high")
        self.high = high
        self.low = low
        self.lat_high_s = lat_high_s
        self.channel = channel
        self._alpha = ewma_alpha
        self._clock = clock or time
        self._ewma = 0.0
        self._stamp = self._clock.monotonic()
        self._open = False
        self._lock = RegisteredLock("orderer.admission.OverloadGate._lock")

    @property
    def is_open(self) -> bool:
        return self._open

    @property
    def latency_ewma_s(self) -> float:
        with self._lock:
            self._decay()
            return self._ewma

    def _decay(self) -> None:
        """Wall-time decay (caller holds the lock): exponential with a
        half-life tied to the latency threshold, so a stall's imprint
        fades within a few thresholds even when every sample is being
        shed."""
        now = self._clock.monotonic()
        dt = now - self._stamp
        self._stamp = now
        if dt <= 0.0 or self._ewma == 0.0:
            return
        half = (self.HALF_LIVES * self.lat_high_s
                if self.lat_high_s > 0.0 else 1.0)
        self._ewma *= 2.0 ** (-dt / half)

    def note_latency(self, seconds: float) -> None:
        with self._lock:
            self._decay()
            self._ewma += self._alpha * (seconds - self._ewma)

    def observe(self, occupancy: float) -> bool:
        """Feed one occupancy sample; returns the (possibly updated)
        gate state."""
        with self._lock:
            self._decay()
            lat_hot = (self.lat_high_s > 0.0
                       and self._ewma >= self.lat_high_s)
            if not self._open:
                if occupancy >= self.high or lat_hot:
                    self._open = True
            else:
                # close only when BOTH pressure signals have receded:
                # occupancy back under the low watermark and (if the
                # latency trigger is armed) the EWMA halved
                if occupancy <= self.low and (
                        self.lat_high_s <= 0.0
                        or self._ewma <= self.lat_high_s / 2.0):
                    self._open = False
            _metrics()["gate"].with_labels(self.channel).set(
                1.0 if self._open else 0.0)
            return self._open

    def retry_after_s(self) -> float:
        """Shed hint while open: a few EWMA latencies (the queue needs
        roughly that long to drain below the band), bounded sane."""
        ewma = self.latency_ewma_s
        return max(0.1, min(5.0, 8.0 * ewma)) if ewma else 0.25


# ---------------------------------------------------------------------------
# the controller Broadcast.submit consults
# ---------------------------------------------------------------------------


class AdmissionController:
    """Per-process admission policy: rate limiter + per-CHANNEL
    overload gates + the metrics that make shedding observable.

    `admit()` runs BEFORE the processor's signature work — the whole
    point is to answer an overload cheaply, not after paying the
    expensive part.  Priority traffic (config updates, orderer txs,
    lifecycle invocations) bypasses both mechanisms.

    The limiter is process-wide (one client = one bucket no matter
    which channel it floods); gate state is per channel — a hot
    channel's full queue must shed ITS traffic, not an idle
    neighbor's, and an idle channel's 0.0 samples must not defeat the
    hot channel's hysteresis.

    The settings are the reference's knobs (:72-110) as arguments, with
    their defaults: `queue_cap` (the chains' bounded submit queue, 0 =
    the blocking 10,000-entry queue; read by the registrar and
    e2e.Network, which pass it to the chains), `rate` and `burst` (the
    per-client limiter, 0 = off; `burst` None = 2 x rate), `shed_high`
    / `shed_low` (the gate's watermarks, clamped to [0, 1] and low <=
    high) and `shed_lat_s` (the latency trigger, 0 = off).  When any of
    `queue_cap`, `rate`, `shed_lat_s` is on, a limiter (rate > 0) and
    the gate template are built from them, as the reference's `from_env`
    does; `limiter` and `gate` instead pass prebuilt ones.  `clock`
    (`monotonic()`) drives the buckets and gates."""

    def __init__(self, limiter: Optional[ClientRateLimiter] = None,
                 gate: Optional[OverloadGate] = None, clock=None,
                 queue_cap: int = 0, rate: float = 0.0,
                 burst: Optional[float] = None,
                 shed_high: float = DEFAULT_SHED_HIGH,
                 shed_low: float = DEFAULT_SHED_LOW,
                 shed_lat_s: float = 0.0):
        self.queue_cap = max(0, int(queue_cap))
        rate = max(0.0, float(rate))
        shed_lat_s = max(0.0, float(shed_lat_s))
        if enabled(self.queue_cap, rate, shed_lat_s):
            if limiter is None and rate > 0.0:
                limiter = ClientRateLimiter(
                    rate, None if burst is None else max(1.0, burst),
                    clock=clock)
            if gate is None:
                high = min(1.0, max(0.0, shed_high))
                low = min(high, max(0.0, shed_low))
                gate = OverloadGate(high, low, lat_high_s=shed_lat_s,
                                    clock=clock)
        self._limiter = limiter
        self._clock = clock or time
        self._template = gate
        self._gates: Dict[str, OverloadGate] = {}
        self._gates_lock = RegisteredLock("orderer.admission._gates_lock")
        if gate is not None:
            self._gates[gate.channel] = gate

    @property
    def enabled(self) -> bool:
        """False: nothing to consult (no bounded queue, limiter or
        gate); Broadcast then skips admission entirely."""
        return (self.queue_cap > 0 or self._limiter is not None
                or self._template is not None)

    @property
    def gate(self) -> Optional[OverloadGate]:
        """The default ("") channel's gate (tests drive this one)."""
        return self._gates.get("") if self._template is not None \
            else None

    def gate_for(self, channel: str) -> Optional[OverloadGate]:
        if self._template is None:
            return None
        with self._gates_lock:
            got = self._gates.get(channel)
            if got is None:
                tpl = self._template
                got = OverloadGate(tpl.high, tpl.low,
                                   lat_high_s=tpl.lat_high_s,
                                   ewma_alpha=tpl._alpha,
                                   clock=self._clock, channel=channel)
                self._gates[channel] = got
            return got

    def throttles_by_client(self) -> Dict[str, int]:
        return (self._limiter.throttles_by_client()
                if self._limiter is not None else {})

    @property
    def has_limiter(self) -> bool:
        """False lets callers skip the client-key hash entirely."""
        return self._limiter is not None

    # -- the decision -----------------------------------------------------
    def admit(self, client: str, priority: bool, occupancy: float,
              channel: str = "") -> None:
        """Raise the typed shed answer, or return (admitted).
        `occupancy` is `channel`'s consenter submit-queue fraction as
        read by the caller (0.0 when the chain doesn't expose one)."""
        _metrics()["occupancy"].with_labels(channel).set(occupancy)
        forced = faults.point("orderer.admission.overload")
        gate = self.gate_for(channel)
        gate_open = gate.observe(occupancy) if gate is not None \
            else False
        if priority:
            return                         # config/lifecycle: always in
        if forced:
            raise shed("forced", "admission gate forced open (chaos)",
                       retry_after_s=0.25)
        if gate_open:
            assert gate is not None
            raise shed(
                "overloaded",
                f"channel {channel!r} overloaded "
                f"(queue {occupancy:.0%} full)",
                retry_after_s=gate.retry_after_s())
        if self._limiter is not None:
            wait = self._limiter.admit(client)
            if wait > 0.0:
                raise shed(
                    "rate_limited",
                    f"client {client} over {self._limiter.rate:g} tx/s",
                    retry_after_s=wait)

    def note_latency(self, seconds: float, channel: str = "") -> None:
        """Feed one ACCEPTED submission's admission latency (route +
        admit + processor + enqueue) into the histogram and the
        channel gate's EWMA trigger."""
        _metrics()["latency"].observe(seconds)
        gate = self.gate_for(channel)
        if gate is not None:
            gate.note_latency(seconds)


# ---------------------------------------------------------------------------
# envelope classification helpers (cheap: header-only parsing)
# ---------------------------------------------------------------------------


def classify(env, is_config_update: bool = False,
             need_client: bool = True) -> Tuple[str, bool]:
    """One-pass (client_key, priority) classification — the envelope
    payload is decoded ONCE; `need_client=False` (no limiter armed)
    skips the signature-header decode + hash entirely.  Shedding must
    cost a header parse, so this is the hot path's only parse.

    client_key: short hash of the signature-header creator (cert
    bytes) — one cert = one bucket no matter how many connections it
    opens.  Unparseable envelopes share the "" bucket: they will be
    rejected by the processor anyway, and a shared bucket stops a
    garbage flood from minting unlimited fresh buckets.

    priority: anything that isn't a plain endorser transaction
    (config updates, orderer txs), plus endorser txs whose channel-
    header extension names the _lifecycle namespace — traffic the
    gate/limiter must never shed."""
    from fabric_mod_tpu_torch.protos import messages as m
    try:
        payload = m.Payload.decode(env.payload)
        ch = m.ChannelHeader.decode(payload.header.channel_header)
    except Exception:
        return "", is_config_update
    client = ""
    if need_client:
        try:
            sh = m.SignatureHeader.decode(
                payload.header.signature_header)
            if sh.creator:
                client = hashlib.sha256(
                    sh.creator).hexdigest()[:16]
        except Exception:
            # a malformed signature header: the shared anonymous
            # client; the processor rejects the envelope later
            pass
    priority = is_config_update or \
        ch.type != m.HeaderType.ENDORSER_TRANSACTION
    if not priority and ch.extension:
        try:
            ext = m.ChaincodeHeaderExtension.decode(ch.extension)
            priority = (ext.chaincode_id is not None
                        and ext.chaincode_id.name == "_lifecycle")
        except Exception:
            # a malformed extension: not priority traffic; the
            # processor surfaces the real decode error
            pass
    return client, priority


def client_key(env) -> str:
    """classify()'s client half (kept for callers that only need the
    bucket key)."""
    return classify(env)[0]


def is_priority(env, is_config_update: bool = False) -> bool:
    """classify()'s priority half (also the bounded queues' full-path
    re-check: a lifecycle tx on a full queue must block like a config
    tx, never shed)."""
    return classify(env, is_config_update, need_client=False)[1]


def chain_occupancy(chain) -> float:
    """Submit-queue occupancy fraction of a consenter, 0.0 when the
    chain doesn't expose `submit_queue_depth()`."""
    depth_fn = getattr(chain, "submit_queue_depth", None)
    if depth_fn is None:
        return 0.0
    try:
        qsize, maxsize = depth_fn()
    except Exception:
        return 0.0
    return (qsize / maxsize) if maxsize else 0.0
