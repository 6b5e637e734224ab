"""The port's process layer (raytracingrenderer_tpu_torch/parallel/
elastic.py and distributed.py, and the command line under ranks) on the
CPU: render_elastic with a worker killed and resumed from its
checkpoint, bit for bit against an uninterrupted worker (as
tests/test_distributed.py holds the JAX package's); init_distributed a
no-op in one process, and a rank asked for a card that is not there
refused (the command line's default -device cuda under 2 ranks, on a
machine whose torch.cuda.is_available() is patched false); host_chip_mesh as a 2 x 2 grid on 4 gloo ranks
(tests/torch_dist.py); `cli.main` with -sceneShards 2 on 2 ranks against
the replicated command line, by the render tests' bar (>= 99% of pixels
within rtol 1e-3 / atol 1e-5, means within 0.5%: the sharded render
takes the scan integrator, the replicated one the wavefront), with
only rank 0 writing."""
import os

import numpy as np
import pytest
import torch

from raytracingrenderer_tpu_torch import cli
from raytracingrenderer_tpu_torch.parallel import distributed
from raytracingrenderer_tpu_torch.parallel.elastic import (
    _ckpt_spp, render_elastic)
from raytracingrenderer_tpu_torch.utils.checkpoint import load_film
from torch_dist import run
from torch_scenes import write_cornell, write_spheres

torch.set_num_threads(2)


def agree(a, b):
    close = np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean()
    assert close >= 0.99, close
    assert abs(a.mean() - b.mean()) <= 0.005 * abs(b.mean())


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """Worker 0 is killed once it has checkpointed a sample; it is
    started again, resumes, and its film equals an uninterrupted
    worker's with the same seed bit for bit; the reduced film is the sum
    of the workers'."""
    scene_dir = write_cornell(str(tmp_path / "cornell"), 16, 16)
    out = str(tmp_path / "run")
    spp = 4
    extra = ["-maxDepth", "2", "-device", "cpu"]
    ck0 = os.path.join(out, "worker0.npz")
    state = {"killed": False}

    def injector(procs):
        if state["killed"]:
            return
        p = procs.get(0)
        if p is not None and p.poll() is None and 1 <= _ckpt_spp(ck0) < spp:
            p.kill()
            state["killed"] = True

    f = render_elastic(scene_dir, out, n_workers=2, spp_per_worker=spp,
                       seed=0, extra_args=extra, on_poll=injector,
                       poll_s=0.05)
    assert state["killed"], "the fault was never injected"
    assert float(f.spp) == 2 * spp
    oracle = str(tmp_path / "oracle")
    render_elastic(scene_dir, oracle, n_workers=1, spp_per_worker=spp,
                   seed=0, extra_args=extra)
    w0 = load_film(ck0, "cpu")
    np.testing.assert_array_equal(
        w0.buffer.numpy(),
        load_film(os.path.join(oracle, "worker0.npz"), "cpu").buffer.numpy())
    w1 = load_film(os.path.join(out, "worker1.npz"), "cpu")
    np.testing.assert_array_equal(f.buffer.numpy(),
                                  w0.buffer.numpy() + w1.buffer.numpy())
    assert not np.array_equal(w0.buffer.numpy(), w1.buffer.numpy())


def test_init_distributed_one_process(monkeypatch):
    """One process makes no group (a world of one is a no-op, as the JAX
    package's), and a LOCAL_RANK with no card of its own raises instead
    of wrapping round."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False
    assert distributed.init_distributed(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    assert distributed.pod_mesh().size == 1
    grid = distributed.host_chip_mesh()
    assert grid.shape == (1, 1) and grid.local.size == 1
    with pytest.raises(ValueError, match="rank"):
        distributed.init_distributed(num_processes=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="no card of its own"):
        distributed._choose_device(None, 1)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert distributed._choose_device(None, 1) == torch.device("cuda", 0)


def test_cuda_without_card_raises(monkeypatch, tmp_path):
    """A rank asked for the card where there is none raises before it
    joins a group: the CLI's default -device cuda under 2 ranks, and
    init_distributed's default device; the CPU only where named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    scene_dir = write_cornell(str(tmp_path / "c"), 8, 8)
    for argv in (["-device", "cuda"], []):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(["-scene", scene_dir, "-SPP", "1", "-outputFilename",
                      str(tmp_path / "x.hdr")] + argv)
    with pytest.raises(RuntimeError, match="is_available"):
        distributed.init_distributed()
    with pytest.raises(RuntimeError, match="is_available"):
        distributed.init_distributed(num_processes=2, process_id=1,
                                     device="cuda:0")
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(str(tmp_path / "x.hdr"))
    assert distributed._choose_device("cpu", 0) == torch.device("cpu")


def test_host_chip_mesh(tmp_path):
    """4 ranks, 2 a host: a (2, 2) grid whose `local` axis sums over a
    host's ranks and whose `cross` axis over one local index."""
    ranks = run("host_chip", 4, tmp_path, env={"LOCAL_WORLD_SIZE": "2"})
    for r, out in enumerate(ranks):
        host, local = divmod(r, 2)
        assert out["shape"] == (2, 2) and out["host"] == host
        assert out["local"] == (local, 2, float(2 * host + 2 * host + 1))
        assert out["cross"] == (host, 2, float(local + local + 2))
        assert out["pod"] == 4.0 and out["axes"] == ("hosts", "rays")


def test_cli_scene_shards(tmp_path):
    """`cli.main` with -sceneShards 2 on 2 ranks: rank 0 alone logs and
    writes the image and the checkpoint, which match the replicated
    command line's; without its ranks the flag is refused."""
    scene_dir = write_spheres(str(tmp_path / "s"), 16, 16, subdiv=2)
    args = ["-scene", scene_dir, "-SPP", "2", "-maxDepth", "2", "-seed",
            "3", "-device", "cpu"]
    out, ck = str(tmp_path / "sharded.hdr"), str(tmp_path / "sharded.npz")
    ranks = run("cli", 2, tmp_path, argv=args + [
        "-outputFilename", out, "-checkpoint", ck, "-sceneShards", "2"])
    assert [r["rc"] for r in ranks] == [0, 0]
    logs = [open(os.path.join(tmp_path, "cli-2", f"rank{r}.log")).read()
            for r in range(2)]
    assert "wrote" in logs[0] and "wrote" not in logs[1]
    ref_out, ref_ck = str(tmp_path / "rep.hdr"), str(tmp_path / "rep.npz")
    assert cli.main(args + ["-outputFilename", ref_out,
                            "-checkpoint", ref_ck]) == 0
    a, b = load_film(ck, "cpu"), load_film(ref_ck, "cpu")
    assert float(a.spp) == float(b.spp) == 2.0
    agree(a.buffer.numpy(), b.buffer.numpy())
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(args + ["-outputFilename", str(tmp_path / "x.hdr"),
                         "-sceneShards", "2"])
    assert not os.path.exists(str(tmp_path / "x.hdr"))
