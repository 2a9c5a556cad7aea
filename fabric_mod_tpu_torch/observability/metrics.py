"""Metrics: counter/gauge/histogram provider abstraction.

The port's copy of fabric_mod_tpu/observability/metrics.py
(`MetricsProvider` :128, `render_prometheus` :188) with plain
`threading.Lock`s where the reference registers its locks with its
race checker (not ported).  Metric names, label order and the text
exposition are the reference's, so the two packages' expositions
compare line for line.

(reference: common/metrics/provider.go — the Counter/Gauge/Histogram
option types every subsystem declares statically — with the prometheus
text exposition of core/operations/system.go:162-193 served by
the reference's observability/opsserver.py; the port has no HTTP
server yet.)

One in-process provider (no statsd): metrics are plain objects with
atomic-enough updates under the GIL; `render_prometheus` emits the
text format scrapers read.  Subsystems declare their metrics up-front
(module-level *Opts constants) exactly like the reference, so a
gendoc-style inventory is greppable.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from fabric_mod_tpu_torch.concurrency import RegisteredLock


class MetricOpts:
    def __init__(self, namespace: str, subsystem: str, name: str,
                 help: str = "", label_names: Sequence[str] = ()):
        self.namespace = namespace
        self.subsystem = subsystem
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)

    @property
    def full_name(self) -> str:
        parts = [p for p in (self.namespace, self.subsystem, self.name) if p]
        return "_".join(parts)


class _Labeled:
    """Base: per-label-values child metrics."""

    def __init__(self, opts: MetricOpts):
        self.opts = opts
        self._children: Dict[Tuple[str, ...], "_Labeled"] = {}
        self._lock = threading.Lock()

    def with_labels(self, *values: str):
        if len(values) != len(self.opts.label_names):
            raise ValueError(
                f"{self.opts.full_name}: expected labels "
                f"{self.opts.label_names}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = type(self)(self.opts)
                self._children[values] = child
            return child

    def _samples(self):
        """[(label_values, self)] for self + children."""
        out = []
        if not self.opts.label_names:
            out.append(((), self))
        with self._lock:
            out.extend((vals, ch) for vals, ch in self._children.items())
        return out


class Counter(_Labeled):
    def __init__(self, opts: MetricOpts):
        super().__init__(opts)
        self.value = 0.0

    def add(self, delta: float = 1.0) -> None:
        self.value += delta


class Gauge(_Labeled):
    def __init__(self, opts: MetricOpts):
        super().__init__(opts)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value

    def add(self, delta: float = 1.0) -> None:
        self.value += delta


_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                    1.0, 2.5, 5.0, 10.0)


class Histogram(_Labeled):
    def __init__(self, opts: MetricOpts,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(opts)
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def time(self):
        """Context manager observing elapsed seconds."""
        hist = self

        class _Timer:
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self._t0)
                return False
        return _Timer()


class MetricsProvider:
    """Registry + factory (reference: metrics.Provider)."""

    def __init__(self):
        self._metrics: List[_Labeled] = []
        self._named: Dict[Tuple[type, str], _Labeled] = {}
        self._lock = RegisteredLock("observability.metrics._lock")

    def new_counter(self, opts: MetricOpts) -> Counter:
        return self._register(Counter(opts))

    def new_gauge(self, opts: MetricOpts) -> Gauge:
        return self._register(Gauge(opts))

    def new_histogram(self, opts: MetricOpts,
                      buckets: Sequence[float] = _DEFAULT_BUCKETS
                      ) -> Histogram:
        return self._register(Histogram(opts, buckets))

    # -- get-or-create by full name ---------------------------------------
    # For metrics declared by LIBRARY code that may instantiate many
    # times (e.g. the bccsp verdict cache): every instance shares one
    # registered metric instead of emitting duplicate exposition rows.

    def counter(self, opts: MetricOpts) -> Counter:
        return self._named_register(Counter, opts)

    def gauge(self, opts: MetricOpts) -> Gauge:
        return self._named_register(Gauge, opts)

    def histogram(self, opts: MetricOpts,
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._named_register(Histogram, opts, buckets)

    def _named_register(self, kind, opts: MetricOpts, *extra):
        key = (kind, opts.full_name)
        with self._lock:
            got = self._named.get(key)
            if got is None:
                got = kind(opts, *extra)
                self._named[key] = got
                self._metrics.append(got)
            return got

    def _register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    # -- prometheus text exposition --------------------------------------
    def render_prometheus(self) -> str:
        out: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for metric in metrics:
            name = metric.opts.full_name
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "histogram"}[type(metric).__name__]
            if metric.opts.help:
                out.append(f"# HELP {name} {metric.opts.help}")
            out.append(f"# TYPE {name} {kind}")
            for vals, child in metric._samples():
                lbl = ""
                if vals:
                    pairs = ",".join(
                        f'{k}="{v}"' for k, v in
                        zip(metric.opts.label_names, vals))
                    lbl = "{" + pairs + "}"
                if isinstance(child, Histogram):
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        lb = (lbl[:-1] + "," if lbl else "{") + \
                            f'le="{b}"' + "}"
                        out.append(f"{name}_bucket{lb} {cum}")
                    cum += child.counts[-1]
                    lb = (lbl[:-1] + "," if lbl else "{") + 'le="+Inf"}'
                    out.append(f"{name}_bucket{lb} {cum}")
                    out.append(f"{name}_sum{lbl} {child.sum}")
                    out.append(f"{name}_count{lbl} {child.count}")
                else:
                    out.append(f"{name}{lbl} {child.value}")
        return "\n".join(out) + "\n"


_default_provider: Optional[MetricsProvider] = None
_default_lock = RegisteredLock("observability.metrics._default_lock")


def default_provider() -> MetricsProvider:
    global _default_provider
    with _default_lock:
        if _default_provider is None:
            _default_provider = MetricsProvider()
        return _default_provider
