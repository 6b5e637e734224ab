"""Where a render on the card parts from the same render on the CPU.

    python -m raytracingrenderer_tpu_torch.probes.trace_gpu_cpu
        [--size 128] [--spp 2] [--out FILE]

The gate of chip_smoke.py renders the cornell box at 128 x 128, 2 spp, on
"cuda" and on "cpu" with the same keys and finds a few pixels in ten
thousand apart.  This script names the torch operators behind them:

  1. it renders the box on "cuda" with the MT kernel, on "cuda" with the
     kernel's plain torch version in its place, and on "cpu", and counts
     the pixels that differ (bitwise, and beyond the gate's rtol 1e-3 /
     atol 1e-5);
  2. it renders once more on "cuda" (plain version) under a
     TorchDispatchMode that runs every operator a second time on the CPU,
     on copies of the very inputs the card was given, and compares the
     two results bit for bit.  An operator that differs there differs by
     its own rounding, not by what it was fed.  The brute-force box goes
     through the scan integrator, so element i of every per-ray tensor is
     pixel i: the first differing operator of each pixel of (1) is the
     one that sends it another way.

It prints a census (operator, calls, calls that differ, most units in
the last place, elements) in the order the operators first differ, and
the first differing operator on the pixels of (1).  Needs a card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from raytracingrenderer_tpu_torch.probes import card, require_cuda

ROOT = Path(__file__).resolve().parents[2]
CFG = dict(mis=True, jitter=True, max_depth=4)


def _scene_writer():
    spec = importlib.util.spec_from_file_location(
        "torch_scenes", ROOT / "tests" / "torch_scenes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two float32 tensors, elementwise
    (0 where both are NaN)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)


class Census(TorchDispatchMode):
    """Runs every operator again on the CPU on copies of its inputs and
    keeps, per operator, how often and how far the card's result parts
    from the CPU's; per element of the `n` rays, the first operator (in
    call order) that differs there."""

    def __init__(self, n: int, device_type: str = "cuda"):
        super().__init__()
        self.n = n
        self.device_type = device_type      # the traced side
        self.calls = 0
        self.ops = {}           # name -> stats, in the order of first differing
        self.first = np.full(n, -1, np.int64)   # call index, per ray
        self.names = {}         # call index -> operator

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        traced = []
        tree_map(lambda x: traced.append(x) if isinstance(x, torch.Tensor)
                 and x.device.type == self.device_type else None,
                 (args, kwargs))
        if not traced:                      # a factory, or host-side work
            return func(*args, **kwargs)

        def to_cpu(x):
            return x.detach().cpu().clone() if isinstance(x, torch.Tensor) \
                else (torch.device("cpu") if isinstance(x, torch.device)
                      else x)

        cpu_args, cpu_kwargs = tree_map(to_cpu, (args, kwargs))
        out = func(*args, **kwargs)
        self.calls += 1
        if not isinstance(out, torch.Tensor) \
                or out.device.type != self.device_type:
            return out
        name = str(func)
        try:
            ref = func(*cpu_args, **cpu_kwargs)
        except Exception as e:              # an operator with no CPU form
            self.ops.setdefault(name + " (not run on the CPU: "
                                + type(e).__name__ + ")",
                                dict(calls=0, differ=0, ulp=0, elements=0))
            return out
        got = out.detach().cpu()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            return out
        if got.dtype == torch.float32:
            d = ulps(got, ref)
        else:
            d = (got != ref).to(torch.int64)
        st = self.ops.get(name)
        differs = bool((d != 0).any())
        if st is None and not differs:
            return out
        if st is None:
            st = self.ops[name] = dict(calls=0, differ=0, ulp=0, elements=0,
                                       dtype=str(got.dtype))
        st["calls"] += 1
        if differs:
            st["differ"] += 1
            st["ulp"] = max(st["ulp"], int(d.max()))
            st["elements"] += int((d != 0).sum())
            lanes = self._lanes(d != 0)
            if lanes is not None:
                new = lanes & (self.first < 0)
                self.first[new] = self.calls
                self.names[self.calls] = name
        return out

    def _lanes(self, mask: torch.Tensor):
        """mask of an output -> per-ray mask, where the output has one
        element (or row, or column) a ray."""
        n = self.n
        if mask.dim() >= 1 and mask.shape[0] == n:
            return mask.reshape(n, -1).any(1).numpy()
        if mask.dim() >= 2 and mask.shape[-1] == n:
            return mask.reshape(-1, n).any(0).numpy()
        if mask.dim() >= 2 and mask.shape[0] * mask.shape[1] == n:
            return mask.reshape(n, -1).any(1).numpy()
        return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the census as JSON")
    args = ap.parse_args()
    require_cuda()
    where = card()
    from raytracingrenderer_tpu_torch.config import RenderConfig
    from raytracingrenderer_tpu_torch.imaging import film as film_mod
    from raytracingrenderer_tpu_torch.ops import mt_kernel
    from raytracingrenderer_tpu_torch.render import render
    from raytracingrenderer_tpu_torch.scene.loader import load_scene
    tmp = tempfile.mkdtemp(prefix="trace_gpu_cpu_")
    scene_dir = _scene_writer().write_cornell(os.path.join(tmp, "cornell"),
                                              args.size, args.size)
    n = args.size * args.size

    def image(dev):
        scene = load_scene(scene_dir, device=dev)
        return film_mod.to_hdr(render(scene, RenderConfig(**CFG),
                                      spp=args.spp)).cpu().numpy()

    kernel_img = image("cuda")
    real = mt_kernel.intersect
    mt_kernel.intersect = lambda tris, o, d, t_init: \
        mt_kernel.intersect_plain(tris, o, d, t_init)
    try:
        plain_img = image("cuda")
        cpu_img = image("cpu")
        census = Census(n)
        with census:
            traced_img = image("cuda")
    finally:
        mt_kernel.intersect = real
    print(f"[{where}] cornell {args.size}x{args.size}, {args.spp} spp")
    print(f"cuda with the MT kernel against cuda with its plain version: "
          f"{int((kernel_img != plain_img).any(-1).sum())} of {n} pixels "
          f"differ bitwise")
    print(f"the traced render against the untraced one: "
          f"{int((traced_img != plain_img).any(-1).sum())} pixels differ")
    bit = (plain_img != cpu_img).any(-1).reshape(n)
    gate = ~np.isclose(plain_img, cpu_img, rtol=1e-3,
                       atol=1e-5).all(-1).reshape(n)
    print(f"cuda against cpu: {int(bit.sum())} pixels differ bitwise, "
          f"{int(gate.sum())} beyond rtol 1e-3 / atol 1e-5 "
          f"({1 - gate.mean():.4%} within)")
    print(f"{census.calls} operator calls on the card; operators whose "
          f"result on the card differs from the CPU's on the same inputs, "
          f"in the order they first differ:")
    print(f"{'operator':<34} {'dtype':<14} {'calls':>6} {'differ':>6} "
          f"{'max ulp':>10} {'elements':>9}")
    for name, st in census.ops.items():
        print(f"{name:<34} {st.get('dtype', ''):<14} {st['calls']:>6} "
              f"{st['differ']:>6} {st['ulp']:>10} {st['elements']:>9}")

    def firsts(mask):
        out = {}
        for call in census.first[mask]:
            key = census.names.get(int(call), "none found")
            out[key] = out.get(key, 0) + 1
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    by_gate, by_bit = firsts(gate), firsts(bit)
    print(f"first differing operator on the {int(gate.sum())} pixels beyond "
          f"the gate: {by_gate}")
    print(f"first differing operator on the {int(bit.sum())} pixels that "
          f"differ bitwise: {by_bit}")
    seen = census.first >= 0
    print(f"{int(seen.sum())} rays met a differing operator; "
          f"{int((seen & ~bit).sum())} of them end on the same pixel value")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=where, size=args.size, spp=args.spp,
                           kernel_vs_plain_pixels=int(
                               (kernel_img != plain_img).any(-1).sum()),
                           bitwise_pixels=int(bit.sum()),
                           gate_pixels=int(gate.sum()), ops=census.ops,
                           first_on_gate_pixels=by_gate,
                           first_on_bitwise_pixels=by_bit), f, indent=1)


if __name__ == "__main__":
    main()
