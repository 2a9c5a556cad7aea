"""The port's metrics registry (fabric_mod_tpu_torch/observability/
metrics.py) against the reference's (fabric_mod_tpu/observability/
metrics.py): the same operations, from one seeded script, give the same
Prometheus text exposition line for line; and the metrics the port's
modules declare carry the reference's names."""
import numpy as np
import pytest

from fabric_mod_tpu.observability import metrics as jmetrics
from fabric_mod_tpu_torch.observability import metrics


def _script(seed: int, n: int = 300):
    """A seeded list of operations over a few declared metrics."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        kind = rng.randint(5)
        label = ["a", "b", "c"][rng.randint(3)]
        value = float(rng.randint(0, 20000)) / 1000.0
        ops.append((kind, label, value))
    return ops


def _drive(mod, ops):
    prov = mod.MetricsProvider()
    plain = prov.new_counter(mod.MetricOpts(
        "fabric", "test", "events_total", help="events"))
    labeled = prov.new_counter(mod.MetricOpts(
        "fabric", "test", "labeled_total", help="by kind",
        label_names=("kind",)))
    gauge = prov.new_gauge(mod.MetricOpts(
        "fabric", "test", "depth", label_names=("channel",)))
    hist = prov.new_histogram(mod.MetricOpts(
        "fabric", "test", "latency_seconds", help="latency"))
    custom = prov.histogram(mod.MetricOpts(
        "", "test", "custom_seconds", label_names=("stage",)),
        buckets=(0.5, 2.0, 8.0))
    # get-or-create by full name: one registered metric, one row
    shared = prov.counter(mod.MetricOpts("fabric", "test", "shared_total"))
    assert prov.counter(mod.MetricOpts(
        "fabric", "test", "shared_total")) is shared
    for kind, label, value in ops:
        if kind == 0:
            plain.add(value)
        elif kind == 1:
            labeled.with_labels(label).add()
        elif kind == 2:
            gauge.with_labels(label).set(value)
        elif kind == 3:
            hist.observe(value)
            shared.add(1)
        else:
            custom.with_labels(label).observe(value)
    with pytest.raises(ValueError):
        labeled.with_labels("x", "y")
    return prov.render_prometheus()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_give_the_same_exposition(seed):
    ops = _script(seed)
    port = _drive(metrics, ops)
    ref = _drive(jmetrics, ops)
    assert port.splitlines() == ref.splitlines()
    assert "fabric_test_latency_seconds_bucket{le=\"+Inf\"} " in port
    assert 'test_custom_seconds_bucket{stage="a",le="0.5"}' in port


def test_histogram_timer_and_empty_registry():
    prov = metrics.MetricsProvider()
    assert prov.render_prometheus() == "\n"
    hist = prov.new_histogram(metrics.MetricOpts("", "", "t_seconds"))
    with hist.time():
        pass
    assert hist.count == 1 and hist.sum >= 0.0
    assert metrics.default_provider() is metrics.default_provider()


def test_port_metrics_carry_the_reference_names():
    """The admission module's and the tracer's metrics, and the kernel
    build counter, land in the port's default registry under the
    reference's names (the build counter under a port name)."""
    from fabric_mod_tpu_torch.observability import tracing
    from fabric_mod_tpu_torch.ops import _build
    from fabric_mod_tpu_torch.orderer import admission
    admission._metrics()
    admission.chain_drop_counter()
    tracing._substage_hist()
    metrics.default_provider().counter(_build._BUILDS_OPTS)
    text = metrics.default_provider().render_prometheus()
    for name in ("fabric_orderer_submit_queue_occupancy",
                 "fabric_orderer_admission_sheds_total",
                 "fabric_orderer_admission_throttles_total",
                 "fabric_orderer_admission_throttled_clients",
                 "fabric_orderer_overload_gate_open",
                 "fabric_orderer_admission_latency_seconds",
                 "fabric_orderer_chain_msgs_dropped_total",
                 "fabric_trace_substage_seconds",
                 "fabric_gpu_kernel_builds_total"):
        assert f"# TYPE {name} " in text, name
    from fabric_mod_tpu.orderer import admission as jadmission
    for key, opts in (("occupancy", admission._OCCUPANCY_OPTS),
                      ("sheds", admission._SHEDS_OPTS),
                      ("latency", admission._LATENCY_OPTS)):
        jopts = getattr(jadmission, f"_{key.upper()}_OPTS")
        assert (opts.full_name, opts.label_names, opts.help) == \
            (jopts.full_name, jopts.label_names, jopts.help)
