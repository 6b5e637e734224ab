"""The port's spans and counts (utils/profiling) and the span walk of
probes/trace_spans.py, on the CPU.

A 16x16 cornell render and one train_step under torch.profiler show the
spans nested as the layers call each other (rtr.pass > rtr.bounce >
rtr.intersect / rtr.shade / rtr.nee / rtr.bsdf / rtr.rng, rtr.train_step
> rtr.forward / rtr.backward / rtr.sgd, rtr.refit after), and a load's
tree build in rtr.load.bvh; without a
profiler recording, or with one that did not switch the spans on, no
record_function is entered; profiling.counting() counts a bounce's
lanes and live lanes; the image and the gradients are the same bit for
bit with spans recorded or not and with counting on or off.  The walk
is held on synthetic events: a span's device-side row leaves the busy
time and the device counts as they were, idle gaps are labelled by the
chain of spans that holds them, an operator of the autograd engine's
thread inside rtr.backward counts toward it, and a host-only trace
gives no device time."""
from types import SimpleNamespace as NS

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracingrenderer_tpu_torch import diff
from raytracingrenderer_tpu_torch.config import RenderConfig
from raytracingrenderer_tpu_torch.geometry.refit import refit
from raytracingrenderer_tpu_torch.imaging import film as film_mod
from raytracingrenderer_tpu_torch.probes import device_rows
from raytracingrenderer_tpu_torch.probes.trace_spans import walk
from raytracingrenderer_tpu_torch.render import render
from raytracingrenderer_tpu_torch.sampling import rng
from raytracingrenderer_tpu_torch.scene.loader import load_scene
from raytracingrenderer_tpu_torch.utils import profiling
from torch_scenes import write_cornell

torch.set_num_threads(2)

RES = 16
CFG = RenderConfig(mis=True, jitter=True, max_depth=4)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return load_scene(write_cornell(str(tmp_path_factory.mktemp("c")),
                                    RES, RES), "cpu")


def _image(scene, cfg=CFG):
    return film_mod.to_hdr(render(scene, cfg, spp=1))


def _step(scene):
    """One train_step toward a black target, then refit -> (scene, loss,
    the gradients as the parameters' change over lr)."""
    new, loss = diff.train_step(scene, torch.zeros(RES, RES, 3),
                                rng.PRNGKey(3), CFG, lr=0.5)
    old, _ = diff._split_scene(scene)
    now, _ = diff._split_scene(new)
    grads = [(a - b) / 0.5 for a, b in zip(diff._leaves(old),
                                           diff._leaves(now))]
    return refit(new), loss, grads


def _spans(prof):
    """[(name, start, end)] of the profile's span rows on the host."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith(profiling.SPAN_PREFIX)
            and str(e.device_type).endswith("CPU")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_nest_as_the_layers_call_each_other(scene):
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.spans_on():
        render(scene, CFG, spp=1)
        _step(scene)
    spans = _spans(prof)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    (pas,) = by["rtr.pass"]
    (ts,) = by["rtr.train_step"]
    (refit_span,) = by["rtr.refit"]
    bounces = [b for b in by["rtr.bounce"] if _inside(b, pas)]
    assert len(bounces) == CFG.max_depth + 2
    for name in ("rtr.intersect", "rtr.shade", "rtr.nee", "rtr.bsdf",
                 "rtr.rng"):
        inner = [s for s in by[name] if _inside(s, pas)]
        assert inner and all(any(_inside(s, b) for b in bounces)
                             for s in inner if name != "rtr.rng")
    # 6 closest hits and 6 shadow batches a pass, the jitter's 2 draws
    # outside the bounces (each one draw, no random_bits span inside)
    assert sum(_inside(s, pas) for s in by["rtr.intersect"]) == 12
    draws = [s for s in by["rtr.rng"] if _inside(s, pas)
             and not any(_inside(s, b) for b in bounces)]
    outer = [s for s in draws
             if not any(t != s and _inside(s, t) for t in draws)]
    assert (len(draws), len(outer)) == (2, 2)
    for name in ("rtr.forward", "rtr.backward", "rtr.sgd"):
        (s,) = by[name]
        assert _inside(s, ts)
    fwd, bwd = by["rtr.forward"][0], by["rtr.backward"][0]
    assert fwd[2] <= bwd[1] <= bwd[2] <= by["rtr.sgd"][0][1]
    # the backward re-runs each bounce from its checkpoint, walking nothing
    recompute = [b for b in by["rtr.bounce"] if _inside(b, bwd)]
    assert len(recompute) == CFG.max_depth + 2
    assert not any(_inside(s, bwd) for s in by["rtr.intersect"])
    assert refit_span[1] >= ts[2]


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered")


def test_no_range_without_a_profiler_or_the_switch(scene, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    with profiling.spans_on():               # no profiler recording
        render(scene, CFG, spp=1)
        _step(scene)
    with profile(activities=[ProfilerActivity.CPU]):   # spans not on
        render(scene, CFG, spp=1)
        _step(scene)
    with pytest.raises(AssertionError, match="entered"):
        with profile(activities=[ProfilerActivity.CPU]), \
                profiling.spans_on():
            render(scene, CFG, spp=1)


@pytest.mark.parametrize("wavefront", [False, True])
def test_counting_counts_lanes_and_live_lanes(scene, wavefront):
    cfg = RenderConfig(mis=True, jitter=True, max_depth=4,
                       wavefront=wavefront)
    assert profiling.counts() is None
    with profiling.counting() as scan:
        render(scene, CFG, spp=1)
    with profiling.counting() as c:
        render(scene, cfg, spp=1)
    assert profiling.counts() is None
    assert scan["lanes"] == RES * RES * (CFG.max_depth + 2)
    assert 0 < scan["live"] <= scan["lanes"]
    assert type(scan["live"]) is int
    # the wavefront runs the same paths, its widths cut to buckets
    assert c["live"] == scan["live"]
    assert c["live"] <= c["lanes"] <= scan["lanes"]
    with pytest.raises(RuntimeError, match="nest"):
        with profiling.counting(), profiling.counting():
            pass


def test_spans_and_counts_change_no_bit(scene):
    img = _image(scene)
    _, loss, grads = _step(scene)
    with profile(activities=[ProfilerActivity.CPU]), profiling.spans_on():
        img_on = _image(scene)
        _, loss_on, grads_on = _step(scene)
    with profiling.counting():
        img_c = _image(scene)
        _, loss_c, grads_c = _step(scene)
    assert torch.equal(img, img_on) and torch.equal(img, img_c)
    assert torch.equal(loss, loss_on) and torch.equal(loss, loss_c)
    for g, a, b in zip(grads, grads_on, grads_c):
        assert torch.equal(g, a) and torch.equal(g, b)


def test_trace_records_the_spans(scene, tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        render(scene, CFG, spp=1)
    text = (tmp_path / "tr" / "trace.json").read_text()
    for name in ("rtr.pass", "rtr.bounce", "rtr.intersect", "rtr.rng"):
        assert f'"{name}"' in text


def test_load_records_the_tree_build(tmp_path):
    """load_scene's BVH build and 4-wide collapse run inside rtr.load.bvh
    when the spans are on; a scene loaded without a tree has none."""
    sdir = write_cornell(str(tmp_path / "c"), RES, RES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.spans_on():
            load_scene(sdir, "cpu")
            load_scene(sdir, "cpu", build_bvh=False)
    assert [n for n, _, _ in _spans(prof)] == ["rtr.load.bvh"]


def test_walk_of_a_cpu_profile(scene):
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            profiling.spans_on():
        render(scene, CFG, spp=1)
        render(scene, CFG, spp=1)
    rec = walk(prof.events(), wall_s=1.0, units=2)
    sp = rec["spans"]
    assert sp["rtr.pass"]["calls"] == 1
    assert sp["rtr.bounce"]["calls"] == CFG.max_depth + 2
    assert sp["rtr.intersect"]["calls"] == 12
    # 8 draws a bounce (4 for NEE, RR, 3 for the BSDF), the jitter's 2;
    # a draw inside another (randint's random_bits) counted in the outer
    assert sp["rtr.rng"]["calls"] == 8 * (CFG.max_depth + 2) + 2
    for row in sp.values():
        assert 0 <= row["self_host_ms"] <= row["host_ms"]
        assert row["device_ms"] == row["kernels"] == row["idle_ms"] == 0
    assert sp["rtr.bounce"]["host_ms"] <= sp["rtr.pass"]["host_ms"]
    assert rec["busy_s"] == rec["device_events"] == 0


# -- the walk on synthetic events --------------------------------------------

def ev(name, a, b, device=False, parent=None, note=False, thread=1, id=0):
    return NS(name=name, time_range=NS(start=a, end=b), cpu_parent=parent,
              is_async=False, thread=thread, is_user_annotation=note, id=id,
              device_type="DeviceType.CUDA" if device else "DeviceType.CPU")


def launched(name, a, b, at, id, parent=None, thread=1):
    """[the runtime call at host time `at`, the kernel [a, b] it
    launched], sharing the correlation id `id`."""
    return [ev("cudaLaunchKernel", at, at + 1, parent=parent,
               thread=thread, id=id),
            ev(name, a, b, device=True, id=id)]


def step_events(annotation=True):
    """A step on the host: rtr.train_step [0, 100] > rtr.forward [0, 40]
    > aten::mul [5, 10] (launching a kernel), then rtr.backward [45, 95]
    on the main thread, while the engine's thread runs
    evaluate_function: MulBackward0 [50, 90] (no cpu_parent; a kernel
    launched at 85) > rtr.bounce [55, 80] > aten::__and__ [60, 70] (a
    kernel).  Device: mul [12, 20], __and__ [72, 77], MulBackward0's
    [84, 96]; with `annotation`, rtr.backward's device-side row [72, 96]
    over the last two and the gap between them."""
    ts = ev("rtr.train_step", 0, 100)
    fwd = ev("rtr.forward", 0, 40, parent=ts)
    mul = ev("aten::mul", 5, 10, parent=fwd)
    bwd = ev("rtr.backward", 45, 95, parent=ts)
    mb = ev("autograd::engine::evaluate_function: MulBackward0", 50, 90,
            thread=2)
    bounce = ev("rtr.bounce", 55, 80, parent=mb, thread=2)
    band = ev("aten::__and__", 60, 70, parent=bounce, thread=2)
    out = [ts, fwd, mul, bwd, mb, bounce, band,
           *launched("mul_kernel", 12, 20, 6, 1, parent=mul),
           *launched("and_kernel", 72, 77, 61, 2, parent=band, thread=2),
           *launched("mulb_kernel", 84, 96, 85, 3, parent=mb, thread=2)]
    if annotation:
        out.append(ev("rtr.backward", 72, 96, device=True, note=True,
                      id=4))
    return out


def test_walk_leaves_a_spans_device_row_out():
    with_row = walk(step_events(True), wall_s=100e-6, units=1)
    without = walk(step_events(False), wall_s=100e-6, units=1)
    for key in ("busy_s", "device_events", "device_us", "idle_gaps",
                "spans"):
        assert with_row[key] == without[key]
    assert with_row["busy_s"] == pytest.approx(25e-6)
    assert with_row["device_events"] == with_row["launched"] == 3
    assert (with_row["annotations"], without["annotations"]) == (1, 0)


def test_walk_labels_gaps_by_span_chain_on_any_thread():
    rec = walk(step_events(), wall_s=100e-6, units=1)
    gaps = dict(rec["idle_gaps"])
    # 20-72 (mid 46): inside the backward, the engine not started yet
    assert gaps["rtr.train_step/rtr.backward > host"] == pytest.approx(52e-6)
    # 77-84 (mid 80.5): the engine thread's operator, outside the bounce
    assert gaps["rtr.train_step/rtr.backward > autograd::engine::"
                "evaluate_function: MulBackward0"] == pytest.approx(7e-6)
    sp = rec["spans"]
    assert sp["rtr.backward"]["idle_ms"] == pytest.approx(0.059)
    assert sp["rtr.train_step"]["idle_ms"] == pytest.approx(0.059)
    assert sp["rtr.forward"]["idle_ms"] == 0
    # kernels launched inside each span's interval, on any thread
    assert sp["rtr.backward"]["device_ms"] == pytest.approx(0.017)
    assert sp["rtr.backward"]["kernels"] == 2
    assert sp["rtr.bounce"]["device_ms"] == pytest.approx(0.005)
    assert sp["rtr.train_step"]["device_ms"] == pytest.approx(0.025)
    # self host: the duration less the child spans' (the bounce on the
    # engine's thread is the backward's child)
    assert sp["rtr.backward"]["self_host_ms"] == pytest.approx(0.025)
    assert sp["rtr.train_step"]["self_host_ms"] == pytest.approx(0.010)


def test_walk_nested_chain_and_same_name_spans():
    """rtr.pass > rtr.bounce > rtr.rng > rtr.rng (a draw inside a draw)
    > aten::__and__; the gap at its midpoint is labelled with the chain,
    the inner draw counted in the outer."""
    pas = ev("rtr.pass", 0, 100)
    bounce = ev("rtr.bounce", 10, 90, parent=pas)
    r1 = ev("rtr.rng", 20, 60, parent=bounce)
    r2 = ev("rtr.rng", 25, 55, parent=r1)
    op = ev("aten::__and__", 30, 50, parent=r2)
    events = [pas, bounce, r1, r2, op, ev("k0", 0, 5, device=True),
              *launched("k", 75, 78, 31, 1, parent=op)]
    rec = walk(events, wall_s=100e-6, units=1)
    assert rec["idle_gaps"] == [
        ["rtr.pass/rtr.bounce/rtr.rng > aten::__and__",
         pytest.approx(70e-6)]]
    sp = rec["spans"]
    assert sp["rtr.rng"]["calls"] == 1
    assert sp["rtr.rng"]["host_ms"] == pytest.approx(0.040)
    assert sp["rtr.rng"]["device_ms"] == pytest.approx(0.003)
    assert sp["rtr.bounce"]["self_host_ms"] == pytest.approx(0.040)


def test_walk_without_spans_labels_as_before():
    """No span in the trace: each gap goes to the outermost operator at
    its midpoint, "host" where none ran; the span table is empty."""
    put = ev("aten::index_put_", 20, 60)
    events = [ev("aten::mul", 0, 10), put,
              ev("aten::_index_put_impl_", 25, 55, parent=put),
              ev("k1", 5, 15, device=True), ev("k2", 30, 40, device=True),
              ev("k3", 84, 90, device=True)]
    rec = walk(events, wall_s=100e-6, units=2)
    assert dict(rec["idle_gaps"]) == {
        "aten::index_put_": pytest.approx(15e-6),
        "host": pytest.approx(44e-6)}
    assert rec["spans"] == {}
    host_only = walk([ev("aten::mul", 0, 10)], wall_s=1e-5, units=1)
    assert host_only["busy_s"] == 0 and host_only["idle_gaps"] == []


def test_device_rows_leave_annotation_rows_out():
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU

    def avg(key, us, device, note=False):
        return NS(key=key, self_device_time_total=us, count=1,
                  device_type=device, is_user_annotation=note)
    rows = device_rows(None, [avg("mt_intersect_kernel", 4.0, cuda),
                              avg("rtr.pass", 9.0, cuda, note=True),
                              avg("aten::mul", 4.0, cpu)])
    assert rows == [("mt_intersect_kernel", 4.0, 1)]
