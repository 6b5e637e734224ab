"""The port imports neither JAX nor the JAX package: in a fresh
interpreter with both blocked in sys.modules, every module of
raytracingrenderer_tpu_torch imports, and none of them builds a kernel
or needs nvcc on import."""
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "raytracingrenderer_tpu"):
    sys.modules[name] = None          # any import of these now fails
import raytracingrenderer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
from raytracingrenderer_tpu_torch.ops import mt_kernel
assert mt_kernel._lib is None and mt_kernel.launches == 0
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and m.split(".")[0] in ("jax", "jaxlib", "raytracingrenderer_tpu")]
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 25
