"""A frozen copy of the renderer's plain PyTorch path tracer, the
yardstick that `correct` is decided against.

It holds what the benchmark's configurations reach, and refuses the
rest: diffuse materials, no coat, no environment map, no .hdr texture.
A configuration that needs more brings the code back with it.

Copied from raytracingrenderer_tpu_torch when this benchmark was
written (the scan integrator, shading, NEE/MIS, BSDFs, lights, RNG,
camera, scene loader and the gradient step) and kept as it was, so that
later changes to the renderer are judged against it.  It imports nothing
of the renderer and runs no kernel of it: intersection is its own
(geometry/intersect.py, every ray against every triangle), the scene is loaded in file
order from the same files, and nothing the renderer derived is reused.
"""
