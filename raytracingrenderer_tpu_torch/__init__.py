"""raytracingrenderer_tpu_torch: the PyTorch and CUDA port of
raytracingrenderer_tpu, for an NVIDIA H100.

Same subpackages and module names as the JAX package, so each module's
counterpart is found by path.  The port imports torch and numpy only;
its kernels (csrc/*.cu) are built with nvcc at first use.  It covers
the path tracer and its gradients (render.py, diff.py) on brute-force
and BVH scenes, environment-map lighting, the AOV, light-tracer, VPL
and adaptive integrators (integrators/dispatch.render_with), and the app
layer: the command line (`python -m raytracingrenderer_tpu_torch.cli`,
on the card unless `-device cpu`), film checkpoints, the denoiser, the
fly camera and the interactive session.  Multi-device rendering
(parallel/) is not ported yet (ROADMAP.md).
"""

__version__ = "0.1.0"
