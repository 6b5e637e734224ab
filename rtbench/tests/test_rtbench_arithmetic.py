"""The end-to-end arithmetic: the 90th percentile, and the kinds' rates
and peaks from their own clocks."""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import pytest

from rtbench import harness, run
from rtbench.tests.conftest import small


def test_p90():
    v = list(np.random.default_rng(3).exponential(1.0, 200))
    p = harness.p90(v)
    assert p == statistics.quantiles(v, n=10)[8]
    assert sum(x > p for x in v) >= 10
    assert harness.p90([5.0]) == 5.0
    assert harness.p90(list(range(1, 101))) == pytest.approx(90.9)


def kind_run(cell, seconds=0.6):
    man = harness.manifest()
    w = harness.cell(man, cell)
    mix_over = small(cell)
    conf = harness.config(man, w["config"])
    mix = dict(harness.mix(w["traffic"]), **mix_over)
    args = argparse.Namespace(seed=11, seconds=seconds, trace=0)
    ctx = run.Run(None, args, w, conf, mix, "cpu", time.perf_counter())
    import torch
    ctx.torch = torch
    return mix, harness.kind(mix["kind"]).run(ctx)


def test_render_rate_and_p90():
    mix, res = kind_run("cornell-box.render-2048")
    rec = res["record"]
    assert res["attempted"] == len(rec["pass_s"]) >= 2
    assert rec["wall_s"] >= 0.6
    assert res["e2e"]["render_pps"] == (mix["width"] * mix["height"]
                                        * res["attempted"] / rec["wall_s"])
    assert res["e2e"]["pass_p90_ms"] == harness.p90(rec["pass_s"]) * 1e3
    assert sum(rec["pass_s"]) <= rec["wall_s"]
    assert res["setup_s"] > 0


def test_train_rate_and_peak():
    mix, res = kind_run("cornell-box.train-512")
    rec = res["record"]
    assert res["attempted"] >= 1 and rec["wall_s"] >= 0.6
    assert res["e2e"]["train_pps"] == (mix["width"] * mix["height"]
                                       * res["attempted"] / rec["wall_s"])
    # on the CPU no device memory is read: 0 bytes, 0 GiB
    assert res["e2e"]["train_peak_gib"] == res["memory_peak_bytes"] == 0
    assert rec["refit_ms"] > 0
