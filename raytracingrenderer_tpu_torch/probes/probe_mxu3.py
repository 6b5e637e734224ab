"""Probe 3 on the card: counterpart of scripts/probe_mxu3.py.  The fp32
visit loop with a min over TT at more visits and more tiles, and the
script's float64 correctness check of its first run (relative error at
most 1e-4 per ray, against max(|ref|, 1e-3)).

    python -m raytracingrenderer_tpu_torch.probes.probe_mxu3
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import visit
from . import R, card, config, flops, inputs, require_cuda, timed_ms, \
    visit_args

# the script's runs, in its order: blocks 8, TT 128, fp32 (HIGHEST)
CONFIGS = [
    config(128, 64, 64, label="v2 repro"),
    config(128, 64, 512, label="more tiles"),
    config(128, 64, 512, label="probe1 shape (V=64, tiles=512)"),
    config(128, 512, 64, label="more visits"),
    config(128, 512, 512, label="more visits+tiles"),
]


def run(cfg, device, where: str):
    tab, feats = inputs(cfg["n_tiles"], cfg["tt"], cfg["blocks"], device)
    ms, (t, _) = timed_ms(lambda: visit.visit(tab, feats,
                                              **visit_args(cfg)))
    visits = cfg["blocks"] * cfg["n_visits"]
    print(f"{cfg['label']:34s} TT={cfg['tt']:4d} V={cfg['n_visits']:3d} "
          f"tiles={cfg['n_tiles']:4d}: {ms:8.3f} ms "
          f"{ms / visits * 1e3:7.2f} us/visit "
          f"{flops(cfg) / ms / 1e9:6.2f} TFLOP/s [{where}]", flush=True)
    return (t.reshape(-1, R).cpu().numpy(), tab.cpu().numpy(),
            feats.cpu().numpy())


def check_correct(out, tab, feats, n_visits, n_tiles, blocks=8) -> bool:
    """The script's check, as it is: per block the running min in
    float64, relative error at most 1e-4."""
    ok = True
    for b in range(blocks):
        f = feats[b * 16:(b + 1) * 16].astype(np.float64)  # (16, R)
        acc = np.full(R, 3e38)
        for i in range(n_visits):
            row = (i * 7) % n_tiles
            tile = tab[row * 16:(row + 1) * 16].astype(np.float64)
            o = tile.T @ f
            acc = np.minimum(acc, o.min(axis=0))
        got = out[b * 8]
        rel = np.abs(got - acc) / np.maximum(np.abs(acc), 1e-3)
        if rel.max() > 1e-4:
            ok = False
            print(f"  block {b}: MAX REL ERR {rel.max():.2e}")
    print("  correctness:", "OK" if ok else "FAIL", flush=True)
    return ok


def main() -> None:
    device = require_cuda()
    where = card()
    print(f"backend: cuda, {torch.cuda.get_device_name(0)}", flush=True)
    for i, cfg in enumerate(CONFIGS):
        out, tab, feats = run(cfg, device, where)
        if i == 0:
            check_correct(out, tab, feats, cfg["n_visits"], cfg["n_tiles"],
                          cfg["blocks"])


if __name__ == "__main__":
    main()
