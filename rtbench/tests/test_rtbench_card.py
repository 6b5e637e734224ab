"""On the card: one short run of a cell through the command, correct,
its result line last.  Skips without a GPU; on the card:
`python -m pytest -q -p no:randomly rtbench/tests -m cuda`."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from rtbench import harness


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload",
         "cornell-box.render-2048", "--seed", str(2 ** 31 + 3), "--seconds",
         "3", "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
