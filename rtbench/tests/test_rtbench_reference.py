"""The plain reference against the renderer on the CPU at test size, one
render pass and train steps of every cell, and the control (the
reference in bfloat16 in the renderer's place) failing every cell."""
from __future__ import annotations

import pytest

from rtbench import control, harness, run
from rtbench.tests.conftest import run_small, small

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_renderer_matches_reference(cell):
    out = run_small(cell, seconds=0.3)
    assert out["correct"], out
    assert out["attempted"] >= 1 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The bfloat16 control fails one of the cell's numbers at least, on
    three seeds."""
    man = harness.manifest()
    w = harness.cell(man, cell)
    mix_over = small(cell)
    conf = harness.config(man, w["config"])
    mix = dict(harness.mix(w["traffic"]), **mix_over)
    lim = run.limits(cell)
    for seed in (3, 2 ** 31 + 9, 10 ** 9 + 7):
        if mix["kind"] == "render":
            got = control.render_readings(conf, mix, seed, ["lowp"], 6,
                                          "cpu")["lowp"]
        else:
            got = control.train_readings(conf, mix, seed, ["lowp"],
                                         "cpu")["lowp"]
        assert any(v > lim[k] for k, v in got.items()), (seed, got)
