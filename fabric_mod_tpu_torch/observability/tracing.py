"""In-process tracing, block timelines, the flight recorder and the device
lens: attribute every commit-path millisecond.

The port's copy of fabric_mod_tpu/observability/tracing.py (spans
:208-297, block timelines :300-364, the recorder :367-516,
`substage_totals` :519, `export_chrome_trace` :525, the device lens
:564-641; reference model: Dapper's trace_id/span_id/parent links with
explicit context propagation across async seams, applied the way
FastFabric profiled Fabric's commit path).

One arming gate: the tracer starts disarmed and `enable(True)` or
`with active():` arms it (there is no environment switch).  Disarmed,
every seam is one module-flag read and NO span object is allocated:
`span()` returns the shared no-op singleton.

* **Spans** — ``with tracing.span("unpack", block=7):`` times one
  operation on the injectable clock (`set_clock`), pushed on a
  thread-local stack so nested spans parent naturally.  Explicit
  carriers cross threads (``current_ctx()``, then ``span(name,
  parent=ctx)``) and processes (``inject()`` / ``extract()``, a
  metadata pair).  Finished spans land in a bounded ring, feed per-name
  totals (the stage attribution) and the
  ``fabric_trace_substage_seconds`` histogram.  Span names are declared
  in observability/spannames.py.

* **Block timelines** — the commit path opens one
  ``start_timeline(consumer, block_num)`` a block; every span that
  finishes while it is installed (``timeline_scope``) becomes one of its
  sub-stage entries.  The commit pipe's stage loop starts it, the
  StagedBlock carries it, the commit loop resumes it and
  ``finish_timeline`` puts it in the flight recorder's ring.

* **The device lens** — `DeviceLens`, from ``device_profile_capture(
  out_dir, counters)``: a one-shot ``torch.profiler`` window (CPU and,
  on a card, CUDA activities) that `bccsp/gpu.GpuVerifier(profile_dir=)`
  opens around one dispatch's marshal, launches and resolve.  It
  synchronizes the card before the window closes, writes the Chrome
  trace into `out_dir`, notes it in the flight recorder, and keeps the
  hand-written kernels' launch counts over the window beside the
  kernel events the trace holds, so a caller can hold one to the other.
  ``compile_count()`` is the port's count of kernel builds and library
  loads (ops/_build.py, ``fabric_gpu_kernel_builds_total``) where the
  reference counts XLA compiles.  On an H100 the window records every hand-written launch of its
  dispatch, with the CUDA runtime linked shared or static, after a
  threaded window and after 30 short ones; after a window of ~10^5
  device activity records it records (almost) no device activity at all
  (scripts/torch_lens_stress.py): open it before any large profiler
  window of the process, as the one-shot first dispatch does.

`auto_dump` is called by the port's fault points and the soak's
SoakError; the reference's circuit breaker, its third caller, is not in
the port.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from fabric_mod_tpu_torch.concurrency import RegisteredLock
from fabric_mod_tpu_torch.observability.metrics import (MetricOpts,
                                                        default_provider)

# the reference's ring defaults (its span-ring and flight-ring knobs)
SPAN_RING = 2048
FLIGHT_RING = 256

# -- the arming gate ---------------------------------------------------------

_enabled = False


def armed() -> bool:
    return _enabled


def enable(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


@contextlib.contextmanager
def active(on: bool = True):
    """Scoped arming (tests, the chip script's traced arms)."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev


# -- clock (injectable: tests drive a ManualClock through spans) -------------

_clock = time.time


def set_clock(fn) -> None:
    """``fn() -> float`` seconds; pass ``time.time`` to restore."""
    global _clock
    _clock = fn


_SUBSTAGE_OPTS = MetricOpts(
    "fabric", "trace", "substage_seconds",
    help="Per-span wall seconds by sub-stage name (the commit "
         "timeline's recv/unpack/der_marshal/device_dispatch/"
         "verdict_await/policy_*/mvcc/ledger_write/fingerprint "
         "split, tracer armed only).",
    label_names=("stage",))


@functools.lru_cache(maxsize=None)
def _substage_hist():
    return default_provider().histogram(
        _SUBSTAGE_OPTS, buckets=(0.0005, 0.002, 0.01, 0.05, 0.25,
                                 1.0, 5.0, 30.0))


# -- context -----------------------------------------------------------------

class TraceContext(collections.namedtuple("TraceContext",
                                          ("trace_id", "span_id"))):
    """The propagated identity a child span needs to link itself under a
    parent across any seam."""
    __slots__ = ()


_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def new_trace_id() -> str:
    return os.urandom(8).hex()


def current_ctx() -> Optional[TraceContext]:
    """This thread's innermost live span as a carrier, or None."""
    st = getattr(_tls, "stack", None)
    if not st:
        return None
    sp = st[-1]
    return TraceContext(sp.trace_id, sp.span_id)


# the metadata carrier (lowercase key, as gRPC metadata requires)
TRACE_METADATA_KEY = "fmt-trace-context"


def inject(ctx: Optional[TraceContext] = None
           ) -> Optional[List[Tuple[str, str]]]:
    """A context as metadata pairs; None when disarmed or no context is
    live."""
    if not _enabled:
        return None
    if ctx is None:
        ctx = current_ctx()
    if ctx is None:
        return None
    return [(TRACE_METADATA_KEY, f"{ctx.trace_id}-{ctx.span_id}")]


def extract(metadata) -> Optional[TraceContext]:
    """The carrier out of metadata (any iterable of (key, value));
    malformed or absent -> None, never a raise: a bad header must not
    fail the call it rode in on."""
    if not metadata:
        return None
    try:
        for key, value in metadata:
            if key == TRACE_METADATA_KEY:
                tid, _, sid = str(value).partition("-")
                if tid and sid:
                    return TraceContext(tid, sid)
    except (TypeError, ValueError):
        return None
    return None


# -- spans -------------------------------------------------------------------

class Span:
    """One timed operation.  On exit it pops the thread's stack, lands
    in the recorder's ring and totals, and, with a block timeline
    installed on this thread, becomes one of its sub-stage entries."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "ts",
                 "dur", "attrs", "thread")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.thread = threading.current_thread().name
        self.ts = 0.0
        self.dur = 0.0

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.ts = _clock()
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur = max(0.0, _clock() - self.ts)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        st = getattr(_tls, "stack", None)
        if st and st[-1] is self:
            st.pop()
        tl = getattr(_tls, "timeline", None)
        if tl is not None:
            tl.add(self.name, self.ts, self.dur)
        _recorder.add_span(self)
        return False

    def to_dict(self) -> Dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "ts": self.ts, "dur": round(self.dur, 6),
                "thread": self.thread, "attrs": self.attrs}


class _NoopSpan:
    """The disarmed singleton: every method a no-op, every entry returns
    itself.  ``span()`` returns THIS object when the tracer is disarmed
    (no allocation, no clock read)."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


def span(name: str, parent=None, **attrs):
    """Open a span.  `parent` may be a TraceContext, a Span, or None
    (the thread's current span, else a fresh trace)."""
    if not _enabled:
        return _NOOP
    if parent is None:
        parent = current_ctx()
    if parent is None:
        trace_id, parent_id = new_trace_id(), None
    else:
        trace_id, parent_id = parent.trace_id, parent.span_id
    return Span(name, trace_id, os.urandom(4).hex(), parent_id, attrs)


# -- block timelines (the flight recorder's unit) ----------------------------

class BlockTimeline:
    """One block's commit-path timeline: every sub-stage span that ran
    while it was installed, across the stage -> commit handoff."""

    __slots__ = ("consumer", "block_num", "trace_id", "ts", "dur",
                 "subs", "_done")

    def __init__(self, consumer: str, block_num: int, trace_id: str):
        self.consumer = consumer
        self.block_num = block_num
        self.trace_id = trace_id
        self.ts = _clock()
        self.dur = 0.0
        self.subs: List[Tuple[str, float, float]] = []
        self._done = False

    def add(self, name: str, ts: float, dur: float) -> None:
        self.subs.append((name, ts, dur))

    def to_dict(self) -> Dict:
        return {"consumer": self.consumer, "block": self.block_num,
                "trace_id": self.trace_id, "ts": self.ts,
                "dur": round(self.dur, 6),
                "subs": [{"name": n, "ts": t, "dur": round(d, 6)}
                         for n, t, d in self.subs]}


def start_timeline(consumer: str, block_num: int,
                   parent: Optional[TraceContext] = None
                   ) -> Optional[BlockTimeline]:
    if not _enabled:
        return None
    return BlockTimeline(
        consumer, block_num,
        parent.trace_id if parent is not None else new_trace_id())


@contextlib.contextmanager
def timeline_scope(tl: Optional[BlockTimeline]):
    """Install `tl` as this thread's timeline (None: no-op); spans
    finishing inside become its sub-stage entries."""
    if tl is None:
        yield None
        return
    prev = getattr(_tls, "timeline", None)
    _tls.timeline = tl
    try:
        yield tl
    finally:
        _tls.timeline = prev


def finish_timeline(tl: Optional[BlockTimeline]) -> None:
    """Close the timeline and push it into the flight recorder's ring
    (idempotent: error paths may finish defensively)."""
    if tl is None or tl._done:
        return
    tl._done = True
    tl.dur = max(0.0, _clock() - tl.ts)
    _recorder.add_timeline(tl)


# -- the recorder ------------------------------------------------------------

class Recorder:
    """Bounded rings of recent spans, block timelines and events, the
    per-name totals (the stage attribution) and the auto-dump
    snapshots.  `span_ring` and `flight_ring` are the reference's
    defaults; `configure_rings` resizes the process-wide one."""

    _DUMP_MIN_INTERVAL_S = 5.0

    def __init__(self, span_ring: int = SPAN_RING,
                 flight_ring: int = FLIGHT_RING):
        self._lock = RegisteredLock("observability.tracing._lock")
        self._spans: collections.deque = collections.deque(
            maxlen=max(8, span_ring))
        self._timelines: collections.deque = collections.deque(
            maxlen=max(8, flight_ring))
        self._events: collections.deque = collections.deque(maxlen=256)
        self._dumps: collections.deque = collections.deque(maxlen=8)
        self._totals: Dict[str, List[float]] = {}   # name -> [secs, n]
        self._last_dump = 0.0

    @property
    def span_ring(self) -> int:
        return self._spans.maxlen

    @property
    def flight_ring(self) -> int:
        return self._timelines.maxlen

    def add_span(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp.to_dict())
            tot = self._totals.get(sp.name)
            if tot is None:
                tot = self._totals[sp.name] = [0.0, 0]
            tot[0] += sp.dur
            tot[1] += 1
        _substage_hist().with_labels(sp.name).observe(sp.dur)

    def add_timeline(self, tl: BlockTimeline) -> None:
        with self._lock:
            self._timelines.append(tl.to_dict())

    def note_event(self, kind: str, detail: str) -> None:
        with self._lock:
            self._events.append(
                {"ts": _clock(), "kind": kind, "detail": detail})

    # -- read surface --------------------------------------------------------
    def recent_spans(self, trace_id: Optional[str] = None,
                     limit: int = 512) -> List[Dict]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        return out[-limit:]

    def timelines(self, limit: Optional[int] = None) -> List[Dict]:
        with self._lock:
            out = list(self._timelines)
        return out if limit is None else out[-limit:]

    def events(self, limit: int = 256) -> List[Dict]:
        with self._lock:
            return list(self._events)[-limit:]

    def totals(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {name: {"secs": round(t[0], 6), "count": int(t[1])}
                    for name, t in self._totals.items()}

    def dumps(self) -> List[Dict]:
        with self._lock:
            return list(self._dumps)

    def span_count(self) -> int:
        with self._lock:
            return len(self._spans)

    def timeline_count(self) -> int:
        with self._lock:
            return len(self._timelines)

    def reset(self) -> None:
        """Clear everything (attribution windows, tests)."""
        with self._lock:
            self._spans.clear()
            self._timelines.clear()
            self._events.clear()
            self._dumps.clear()
            self._totals.clear()
            self._last_dump = 0.0

    def auto_dump(self, reason: str) -> Optional[Dict]:
        """Snapshot the recorder on a failure signal; rate-limited, and
        the "dump" event is appended only when a snapshot was taken."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump < self._DUMP_MIN_INTERVAL_S \
                    and self._dumps:
                return None
            self._last_dump = now
            snap = {"reason": reason, "ts": _clock(),
                    "timelines": list(self._timelines)[-32:],
                    "events": list(self._events)[-64:]}
            self._dumps.append(snap)
            self._events.append(
                {"ts": _clock(), "kind": "dump", "detail": reason})
        return snap


_recorder = Recorder()


def recorder() -> Recorder:
    return _recorder


def configure_rings(span_ring: int = SPAN_RING,
                    flight_ring: int = FLIGHT_RING) -> Recorder:
    """Replace the process-wide recorder with one of these ring sizes
    (floor 8 each) and return it; what the old one held is dropped."""
    global _recorder
    _recorder = Recorder(span_ring, flight_ring)
    return _recorder


def note_event(kind: str, detail: str) -> None:
    """A one-line event into the flight recorder (armed only)."""
    if _enabled:
        _recorder.note_event(kind, detail)


def auto_dump(reason: str) -> None:
    if _enabled:
        _recorder.auto_dump(reason)


def flight_text(limit: int = 8) -> str:
    """The flight recorder's tail for error text: the last `limit` block
    timelines, one line each, and the recent events."""
    lines = [f"flight recorder (last {limit} block timelines):"]
    for tl in _recorder.timelines(limit):
        subs = " ".join(f"{s['name']}={s['dur'] * 1000:.1f}ms"
                        for s in tl["subs"])
        lines.append(
            f"  [{tl['consumer']}] block {tl['block']} "
            f"trace {tl['trace_id']} dur {tl['dur'] * 1000:.1f}ms: "
            f"{subs or '(no sub-spans)'}")
    ev = _recorder.events()[-limit:]
    if ev:
        lines.append("recent events: " + "; ".join(
            f"{e['kind']}:{e['detail']}" for e in ev))
    return "\n".join(lines)


def flight_dump() -> Dict:
    """The flight recorder whole: ring, events, auto-dumps, totals."""
    return {"armed": _enabled,
            "timelines": _recorder.timelines(),
            "events": _recorder.events(),
            "dumps": _recorder.dumps(),
            "totals": _recorder.totals()}


def substage_totals() -> Dict[str, Dict[str, float]]:
    return _recorder.totals()


# -- Chrome trace-event export (Perfetto-loadable) ---------------------------

def export_chrome_trace(path: str) -> int:
    """Write the span ring as Chrome trace-event JSON: one complete ("X")
    event a span (ts/dur in µs), device dispatches ALSO as async
    ("b"/"e") slices so the device lane reads as its own track.  Returns
    the number of events written."""
    pid = os.getpid()
    events: List[Dict] = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": "fabric_mod_tpu_torch"}}]
    tids: Dict[str, int] = {}
    for sp in _recorder.recent_spans(limit=_recorder.span_ring):
        tid = tids.setdefault(sp["thread"], len(tids) + 1)
        events.append({
            "ph": "X", "pid": pid, "tid": tid, "name": sp["name"],
            "cat": "span", "ts": round(sp["ts"] * 1e6, 1),
            "dur": round(sp["dur"] * 1e6, 1),
            "args": {"trace_id": sp["trace_id"],
                     "span_id": sp["span_id"],
                     "parent_id": sp["parent_id"], **sp["attrs"]}})
        if sp["name"] == "device_dispatch":
            ts = round(sp["ts"] * 1e6, 1)
            common = {"pid": pid, "tid": tid, "cat": "device",
                      "name": "device_batch", "id": sp["span_id"]}
            events.append({"ph": "b", "ts": ts, **common})
            events.append({
                "ph": "e", "ts": round((sp["ts"] + sp["dur"]) * 1e6, 1),
                **common})
    for name, tid in tids.items():
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms",
                   "otherData": {"kernel_builds": compile_count(),
                                 "substage_totals": substage_totals()}},
                  f)
    return len(events)


# -- device lens: the build counter and a one-shot torch.profiler window -----

def compile_count() -> int:
    """The port's kernel builds and library loads so far (ops/_build.py,
    ``fabric_gpu_kernel_builds_total``)."""
    from fabric_mod_tpu_torch.ops import _build
    return _build.build_count()


def trace_kernel_counts(path: str) -> Dict[str, int]:
    """{kernel name: events} of the device kernels in a Chrome trace that
    torch.profiler wrote (events of category "kernel"; the name is cut
    at its argument list, so a C++ signature counts under its function
    name)."""
    with open(path) as f:
        doc = json.load(f)
    out: Dict[str, int] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("cat") != "kernel" or ev.get("ph") != "X":
            continue
        name = str(ev.get("name", "")).split("(", 1)[0].strip()
        name = name.rsplit(" ", 1)[-1]      # drop a "void " return type
        out[name] = out.get(name, 0) + 1
    return out


class DeviceLens:
    """One torch.profiler window around one device dispatch.

    `counters()` returns {kernel name: launches so far} (the wrappers'
    own counts); the window keeps their difference over its span in
    `launches`.  On exit it synchronizes `device` (when it is a card)
    before the profiler stops, so every launch of the window has ended
    inside it, writes the Chrome trace to `path` and notes it.
    `trace_kernels` then holds the trace's kernel events per name.  A
    profiler that cannot start raises: the lens never skips quietly."""

    def __init__(self, out_dir: str, device=None,
                 counters: Optional[Callable[[], Dict[str, int]]] = None):
        self.out_dir = out_dir
        self.device = device
        self._counters = counters
        self.path: Optional[str] = None
        self.launches: Dict[str, int] = {}
        self.trace_kernels: Dict[str, int] = {}
        self._before: Dict[str, int] = {}
        self._prof = None

    def _on_card(self) -> bool:
        return self.device is not None and \
            getattr(self.device, "type", str(self.device)) == "cuda"

    def __enter__(self) -> "DeviceLens":
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(self.out_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self._on_card():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._before = dict(self._counters()) if self._counters else {}
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        import torch
        try:
            if self._on_card():
                torch.cuda.synchronize(self.device)
        finally:
            self._prof.__exit__(exc_type, exc, tb)
        after = dict(self._counters()) if self._counters else {}
        self.launches = {k: v - self._before.get(k, 0)
                         for k, v in after.items()
                         if v - self._before.get(k, 0)}
        if exc_type is None:
            self.path = os.path.join(
                self.out_dir, f"gpu_lens_{os.getpid()}.json")
            self._prof.export_chrome_trace(self.path)
            self.trace_kernels = trace_kernel_counts(self.path)
            note_event("device_profile", self.path)
        return False

    def kernel_table(self) -> Dict[str, Tuple[int, int]]:
        """{counter name: (launches counted in the window, events of
        kernel `<name>_kernel` in the trace)} for every kernel either
        side saw: the gate holds the two equal."""
        names = set(self.launches) | {
            k[:-len("_kernel")] for k in self.trace_kernels
            if k.endswith("_kernel")}
        return {n: (self.launches.get(n, 0),
                    self.trace_kernels.get(n + "_kernel", 0))
                for n in sorted(names)}


_profile_lock = RegisteredLock("observability.tracing._profile_lock")
_profile_taken = False
_last_lens: Optional[DeviceLens] = None


def device_profile_capture(out_dir: Optional[str], device=None,
                           counters=None) -> Optional[DeviceLens]:
    """The one-shot window: a DeviceLens on the FIRST call in this
    process with the tracer armed and `out_dir` given, else None.
    Callers run the dispatch AND its resolve inside it, so the trace
    holds the device's execution, not just the host enqueue."""
    global _profile_taken, _last_lens
    if not _enabled or out_dir is None:
        return None
    with _profile_lock:
        if _profile_taken:
            return None
        _profile_taken = True
        _last_lens = DeviceLens(out_dir, device, counters)
    return _last_lens


def last_lens() -> Optional[DeviceLens]:
    """The window this process opened, or None."""
    return _last_lens


def rearm_device_profile() -> None:
    """Make the next armed `device_profile_capture` open a window again
    (tests of the one-shot rule)."""
    global _profile_taken, _last_lens
    with _profile_lock:
        _profile_taken = False
        _last_lens = None
