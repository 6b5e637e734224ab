"""No JAX and no JAX package in a benchmark run, compared by whole
top-level names; nothing of the renderer in the reference."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from rtbench import harness

PORT = "raytracingrenderer_tpu_torch"


def test_forbidden_compares_whole_names():
    ok = ["raytracingrenderer_tpu_torch", "raytracingrenderer_tpu_torch.render",
          "jaxtyping", "flaxen.x", "torch", "numpy.linalg"]
    assert harness.forbidden_modules(ok) == []
    bad = ["jax.numpy", "jaxlib", "flax.linen", "raytracingrenderer_tpu",
           "raytracingrenderer_tpu.render"]
    assert harness.forbidden_modules(ok + bad) == [
        "flax", "jax", "jaxlib", "raytracingrenderer_tpu"]


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_renderer():
    files = sorted((harness.BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        for name in imported(f):
            top = name.split(".")[0]
            assert top not in (PORT, "jax", "jaxlib", "flax",
                               "raytracingrenderer_tpu"), (f, name)


def run_py(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax():
    """A whole run of a cell (CPU, test size) in a fresh interpreter, then
    its modules: none of JAX or of the JAX package."""
    got = run_py(
        "import sys, time, argparse, torch; torch.set_num_threads(2); "
        "from rtbench import run, harness; "
        "a = argparse.Namespace(workload='cornell-box.render-2048', seed=5, "
        "seconds=0.3, trace=0); "
        "out = run.execute(a, 'cpu', time.perf_counter(), "
        "dict(width=16, height=16, band_rows=4)); "
        "assert out['correct'], out; "
        "print(harness.forbidden_modules(), "
        f"'{PORT}' in sys.modules)")
    assert got.split() == ["[]", "True"]


def test_the_reference_loads_nothing_of_the_renderer():
    got = run_py(
        "import sys; import rtbench.reference.compare, rtbench.control; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        f"{{'{PORT}', 'jax', 'raytracingrenderer_tpu'}}))")
    assert got.strip() == "[]"


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints
    nothing on standard output."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload",
         "cornell-box.render-2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is false" in out.stderr
