"""raytracingrenderer_tpu_torch: the PyTorch and CUDA port of
raytracingrenderer_tpu, for an NVIDIA H100.

Same subpackages and module names as the JAX package, so each module's
counterpart is found by path.  The port imports torch and numpy only;
its kernels (csrc/*.cu) are built with nvcc at first use.  This slice
covers the forward path tracer on brute-force-intersected scenes (64
triangles or fewer, e.g. cornell-box).
"""

__version__ = "0.1.0"
