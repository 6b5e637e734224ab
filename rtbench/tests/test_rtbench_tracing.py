"""The profiler walk and the per-layer readers on a synthetic event list."""
from __future__ import annotations

from types import SimpleNamespace as NS

import pytest

from rtbench import harness, tracing


def ev(name, a, b, device=False, parent=None, dev_us=0.0):
    e = NS(name=name, time_range=NS(start=a, end=b), cpu_parent=parent,
           is_async=False, device_time_total=dev_us,
           device_type="DeviceType.CUDA" if device else "DeviceType.CPU")
    return e


def events():
    """Host: aten::mul [0, 10], aten::index_put_ [20, 60] with a child
    aten::_index_put_impl_ [25, 55]; device: a mul kernel [5, 15], the
    scatter's sort [30, 40] and indexing_backward [42, 70], B2 [80, 90]
    (idle gaps: 15-30 under index_put_, 40-42 under index_put_, 70-80
    under no op)."""
    mul = ev("aten::mul", 0, 10)
    put = ev("aten::index_put_", 20, 60, dev_us=38.0)
    impl = ev("aten::_index_put_impl_", 25, 55, parent=put, dev_us=38.0)
    return [mul, put, impl,
            ev("elementwise_kernel<MulFunctor>", 5, 15, device=True),
            ev("radix_sort", 30, 40, device=True),
            ev("indexing_backward_kernel", 42, 70, device=True),
            ev("void bvh_traverse_kernel<false, 14>", 80, 90,
               device=True)]


def test_summarize():
    rec = tracing.summarize(events(), wall_s=100e-6, units=2)
    assert rec["busy_s"] == pytest.approx(58e-6)
    assert rec["device_events"] == 4
    assert rec["device_us"] == pytest.approx(58.0)
    assert rec["isect_us"] == pytest.approx(10.0)
    assert rec["scatter_us"] == pytest.approx(38.0)   # the outer op once
    gaps = dict(rec["idle_gaps"])
    assert gaps["aten::index_put_"] == pytest.approx(17e-6)
    assert gaps["host"] == pytest.approx(10e-6)
    ops = dict(rec["device_ops"])
    assert ops["indexing_backward_kernel"] == pytest.approx(28e-6)
    assert list(ops)[0] == "indexing_backward_kernel"


def test_overlapping_kernels_count_once_in_busy():
    e = [ev("k1", 0, 10, device=True), ev("k2", 5, 12, device=True)]
    rec = tracing.summarize(e, wall_s=20e-6, units=1)
    assert rec["busy_s"] == pytest.approx(12e-6)
    assert rec["device_us"] == pytest.approx(17.0)


def test_readers():
    rec = tracing.summarize(events(), wall_s=100e-6, units=2)
    rec.update(load_s=4.5, refit_ms=64.0)

    def read(name):
        return harness.metric_reader(name).read(rec)
    assert read("load_s") == 4.5
    assert read("refit_ms") == 64.0
    assert read("launches_per_pass") == 2.0
    assert read("isect_ms_per_pass") == pytest.approx(0.005)
    assert read("idle_pct.render") == pytest.approx(42.0)
    assert read("idle_pct.train") == pytest.approx(42.0)
    assert read("scatter_pct") == pytest.approx(100.0 * 38.0 / 58.0)


def test_readers_find_nothing_on_a_host_only_trace():
    """A trace with no device events (a CPU run) gives no device metric,
    never a 0 share."""
    rec = tracing.summarize([ev("aten::mul", 0, 10)], wall_s=1e-5, units=1)
    for name in ("launches_per_pass", "isect_ms_per_pass",
                 "idle_pct.render", "idle_pct.train", "scatter_pct"):
        assert harness.metric_reader(name).read(rec) is None
    assert harness.metric_reader("refit_ms").read({}) is None
