"""Elastic multi-process rendering: failure detection and recovery from
film checkpoints.

Counterpart of raytracingrenderer_tpu/parallel/elastic.py.  Each worker
is a plain command-line render (`python -m raytracingrenderer_tpu_torch.cli`)
of its own samples, with a seed of its own, checkpointing its film after
every sample.  The supervisor polls the workers; one that dies (crash,
out of memory, preemption, kill) or ends short of its target is started
again and resumes from its last checkpoint, rendering only the samples
after it.  Every sample is keyed by (seed, sample index, pixel), so the
recovered film equals an uninterrupted one bit for bit, and the result
is the sum of the workers' films (buffers and sample counts): the
cross-process all_reduce's file-level twin.

The workers run from the repository root, so they find the kernels that
an earlier run built under build/kernels (ops/build.py) and build
nothing again; `extra_args` passes them flags such as -device.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..imaging import film as film_mod
from ..utils.checkpoint import load_film
from ..utils.log import get_logger

_log = get_logger("elastic")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _ckpt_spp(path: str) -> int:
    f = load_film(path, device="cpu")
    return int(f.spp) if f is not None else 0


def _spawn(scene: str, out_dir: str, worker: int, target_spp: int,
           seed: int, extra_args: List[str]) -> Optional[subprocess.Popen]:
    ck = os.path.join(out_dir, f"worker{worker}.npz")
    remaining = target_spp - _ckpt_spp(ck)
    if remaining <= 0:
        return None
    cmd = [sys.executable, "-m", "raytracingrenderer_tpu_torch.cli",
           "-scene", scene,
           "-outputFilename", os.path.join(out_dir, f"w{worker}.hdr"),
           "-SPP", str(remaining),
           "-checkpoint", ck, "-checkpointEvery", "1",
           "-seed", str(seed + worker)] + list(extra_args)
    # a worker is one process: no torchrun rank of the supervisor's
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    # its output goes to a file: a pipe nobody reads would stall it
    with open(_log_path(out_dir, worker), "a") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)


def _log_path(out_dir: str, worker: int) -> str:
    return os.path.join(out_dir, f"worker{worker}.log")


def render_elastic(scene: str, out_dir: str, n_workers: int,
                   spp_per_worker: int, seed: int = 0,
                   extra_args: Optional[List[str]] = None,
                   on_poll: Optional[Callable] = None,
                   poll_s: float = 0.5,
                   max_restarts: int = 8) -> film_mod.Film:
    """Render `spp_per_worker` samples on each of `n_workers` processes,
    starting again any worker that dies, from its film checkpoint; returns
    the reduced film (the sum of the buffers and of the sample counts),
    on the CPU.

    `on_poll(procs)` runs at every poll (a test's fault injector kills a
    live worker through it).  A worker has failed when its process exits
    nonzero, or exits before its checkpoint reaches the target; each
    failure spends one of `max_restarts`, and one more raises."""
    os.makedirs(out_dir, exist_ok=True)
    extra_args = extra_args or []
    procs: Dict[int, Optional[subprocess.Popen]] = {}
    restarts = 0
    try:
        for w in range(n_workers):
            procs[w] = _spawn(scene, out_dir, w, spp_per_worker, seed,
                              extra_args)
        while True:
            if on_poll is not None:
                on_poll(procs)
            for w in range(n_workers):
                p = procs.get(w)
                if p is None or p.poll() is None:
                    continue
                done = _ckpt_spp(os.path.join(out_dir, f"worker{w}.npz"))
                if p.returncode == 0 and done >= spp_per_worker:
                    procs[w] = None
                    continue
                restarts += 1
                with open(_log_path(out_dir, w)) as f:
                    tail = f.read()[-2000:]
                _log.warning("worker %d died (rc=%s, %d/%d spp), restarting "
                             "from its checkpoint; its output ended:\n%s", w,
                             p.returncode, done, spp_per_worker, tail)
                if restarts > max_restarts:
                    raise RuntimeError(
                        f"worker {w} exceeded {max_restarts} restarts")
                procs[w] = _spawn(scene, out_dir, w, spp_per_worker, seed,
                                  extra_args)
            if all(p is None for p in procs.values()):
                break
            time.sleep(poll_s)
    finally:
        for p in procs.values():
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()

    films = [load_film(os.path.join(out_dir, f"worker{w}.npz"), device="cpu")
             for w in range(n_workers)]
    buf = np.sum([f.buffer.numpy() for f in films], axis=0)
    spp = float(sum(float(f.spp) for f in films))
    return film_mod.Film(buffer=torch.from_numpy(buf),
                         spp=torch.tensor(spp, dtype=torch.float32))
