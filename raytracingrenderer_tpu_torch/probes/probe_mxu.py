"""Probe 1 on the card: counterpart of scripts/probe_mxu.py.

  1. the visit loop's throughput at K = 16: n_visits (16, TT) x (16, R)
     contractions per block of rays against a resident table, each
     followed by a min over TT or the constant-form MT epilogue, in TF32
     ("default", the tensor cores) and fp32 ("highest", the CUDA cores);
  2. the precision of a (16, 128) x (16, 4096) dot in both modes against
     float64;
  3. the relayout loop between the (32, 128) and (1, 4096) views.

The script's epilogue run fails at trace on the TPU side (its t_b has 8
rows, the quarters 32: probe_mxu.py:76-78); here it runs with t_b the
ray's running best, one value a ray, which the epilogue intends.

    python -m raytracingrenderer_tpu_torch.probes.probe_mxu
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import visit
from . import R, card, config, flops, inputs, require_cuda, timed_ms, \
    visit_args

TT = 128          # triangles per treelet tile
V = 64            # visits per block per kernel call
RELAYOUT_BLOCKS = 64

# bench_matmul's three runs, in the script's order
CONFIGS = [
    config(TT, V, 512, precision="default", label="matmul-only"),
    config(TT, V, 512, label="matmul-only"),
    config(TT, V, 512, reduce="mt", label="matmul+epilogue"),
]


def bench_matmul(cfg, device, where: str) -> float:
    tab, feats = inputs(cfg["n_tiles"], cfg["tt"], cfg["blocks"], device)
    ms, _ = timed_ms(lambda: visit.visit(tab, feats, **visit_args(cfg)))
    visits = cfg["blocks"] * cfg["n_visits"]
    print(f"{cfg['label']}[{cfg['precision'].upper()}]: {ms:.3f} ms for "
          f"{cfg['blocks']}x{cfg['n_visits']} visits "
          f"({ms / visits * 1e3:.2f} us/visit, "
          f"{flops(cfg) / ms / 1e9:.2f} TFLOP/s effective) [{where}]",
          flush=True)
    return ms


def precision_inputs(device):
    """The script's operands: a (16, TT) and b (16, R), both x 100, from
    one generator of seed 2."""
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(16, TT)) * 100).astype(np.float32)
    b = (rng.normal(size=(16, R)) * 100).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def precision_check(device, where: str):
    """-> {precision: (median, max)} relative error of the dot against
    float64, |out - ref| / max(|ref|, 1e-3), as the script measures."""
    a, b = precision_inputs(device)
    ref = a.double().cpu().numpy().T @ b.double().cpu().numpy()
    res = {}
    for prec in ("default", "highest"):
        out = visit.dot(a, b, prec).cpu().numpy()
        rel = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-3)
        res[prec] = (float(np.median(rel)), float(rel.max()))
        print(f"cuda f32 dot [{prec.upper()}] relative error: median "
              f"{res[prec][0]:.2e} max {res[prec][1]:.2e} [{where}]",
              flush=True)
    return res


def bench_relayout(device, where: str):
    x = torch.zeros((RELAYOUT_BLOCKS * 32, 128), dtype=torch.float32,
                    device=device)
    for n_iter in (1, 65):
        ms, _ = timed_ms(lambda: visit.relayout_loop(x, n_iter))
        print(f"relayout loop n={n_iter}: {ms:.4f} ms [{where}]", flush=True)


def main() -> None:
    device = require_cuda()
    where = card()
    print(f"backend: cuda, {torch.cuda.get_device_name(0)}", flush=True)
    precision_check(device, where)
    for cfg in CONFIGS:
        bench_matmul(cfg, device, where)
    bench_relayout(device, where)


if __name__ == "__main__":
    main()
