"""Probe 2 on the card: counterpart of scripts/probe_mxu2.py.  One
factor of the fp32 visit loop varied at a time: tile size, the dynamic
tile read against a static one, the min over TT against rows 0..7 kept
apart, the lane layout (the counterpart of the (R, 16) x (16, TT)
orientation, its min across the lanes of a warp), and 8 tiles per step.

    python -m raytracingrenderer_tpu_torch.probes.probe_mxu2
"""
from __future__ import annotations

import torch

from ..ops import visit
from . import card, config, flops, inputs, require_cuda, timed_ms, visit_args

# the script's runs, in its order: blocks 8, n_tiles 64, fp32 (HIGHEST)
CONFIGS = [
    config(128, 64, 64, label="full (dyn slice+dot+reduce)"),
    config(512, 16, 64, label="full (dyn slice+dot+reduce)"),
    config(128, 64, 64, tile="static", label="static tile"),
    config(128, 64, 64, reduce="first8", label="no cross-sublane reduce"),
    config(128, 64, 64, layout="lane", label="rays-major (R,16)x(16,TT)"),
    config(128, 64, 64, tile="batched8", label="8-tiles-per-dot wide"),
]


def run(cfg, device, where: str) -> float:
    tab, feats = inputs(cfg["n_tiles"], cfg["tt"], cfg["blocks"], device)
    ms, _ = timed_ms(lambda: visit.visit(tab, feats, **visit_args(cfg)))
    visits = cfg["blocks"] * cfg["n_visits"]
    print(f"{cfg['label']:42s} TT={cfg['tt']:4d}: {ms:8.3f} ms "
          f"{ms / visits * 1e3:7.2f} us/visit "
          f"{flops(cfg) / ms / 1e9:6.2f} TFLOP/s [{where}]", flush=True)
    return ms


def main() -> None:
    device = require_cuda()
    where = card()
    print(f"backend: cuda, {torch.cuda.get_device_name(0)}", flush=True)
    for cfg in CONFIGS:
        run(cfg, device, where)


if __name__ == "__main__":
    main()
