"""Ranks as a mesh, and ray-sharded rendering over it.

Counterpart of raytracingrenderer_tpu/parallel/mesh.py.  The JAX package
drives a `Mesh` of local devices from one controller and lets XLA
partition the render over its `rays` axis.  Here every device is driven
by a process of its own, one rank, as torch.distributed runs it
(`torchrun`, parallel/distributed.py): a mesh is a process group, this
rank's place in it and this rank's device, and each JAX collective is a
torch.distributed one (`psum` is `all_reduce`).  A mesh of one rank with
no process group is the JAX one-device mesh: its collectives are
identities.

Rays are split in contiguous bands of the leading axis, ceil(n / size)
a rank, so the last band may be shorter (or empty).  Every random number
is keyed by the global index of its pixel or lane (sampling/rng.py), so
a band draws what the whole batch draws there, and `render_sharded`'s
image equals `render.sample_image`'s bit for bit for any rank count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

RAY_AXIS = "rays"

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A group of ranks along one axis (`rays`, RAY_AXIS, unless a
    distributed.HostChipMesh says otherwise).

    `group` is the process group (None: one rank, no process group);
    `rank` is this process's index in it (-1 where this process is not a
    member); `size` its number of ranks; `device` this rank's device."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    @property
    def is_member(self) -> bool:
        return self.rank >= 0

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   async_op: bool = False):
        """In-place all_reduce of `t` over the mesh ("sum", "min" or
        "max"); with async_op, returns the work handle to wait on (None
        for a one-rank mesh)."""
        self._check_member()
        if self.group is None:
            return None
        return dist.all_reduce(t, op=_OPS[op], group=self.group,
                               async_op=async_op)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> None:
        """In-place broadcast of `t` from mesh rank `src`."""
        self._check_member()
        if self.group is not None:
            dist.broadcast(t, dist.get_global_rank(self.group, src),
                           group=self.group)

    def band(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's contiguous share of n items: ceil(n /
        size) a rank, the last band shorter or empty."""
        self._check_member()
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)

    def _check_member(self) -> None:
        if not self.is_member:
            raise ValueError("this process is not a rank of the mesh")


def _default_device() -> torch.device:
    from .distributed import rank_device
    return rank_device()


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The first n_devices ranks of the default process group (all of
    them by default).  Without a process group this process is the only
    rank, and only a mesh of one rank exists.  A mesh of fewer ranks than
    the group is a new group, which every rank of the default group must
    make together."""
    device = torch.device(device) if device is not None \
        else _default_device()
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh({n_devices}): this process is one rank with no "
                f"process group; start {n_devices} ranks (torchrun "
                f"--nproc_per_node {n_devices} ...) and call "
                f"parallel.distributed.init_distributed() first")
        return Mesh(None, 0, 1, device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n}): the process group has {world} "
                         f"ranks (torchrun --nproc_per_node sets them)")
    rank = dist.get_rank()
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    return Mesh(group, rank if rank < n else -1, n, device)


def _map(fn, tree):
    """fn over every tensor of a tensor, tuple (V3 and NamedTuples
    included), list or dict."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_rays(mesh: Mesh, tree):
    """This rank's band of the leading (ray / pixel) axis of every
    tensor of `tree`."""
    def take(x):
        lo, hi = mesh.band(x.shape[0])
        return x[lo:hi]
    return _map(take, tree)


def shard_rows(mesh: Mesh, tree):
    """This rank's band of rows of (H, W, 3)-style images: rows are their
    leading axis, so this is `shard_rays`."""
    return shard_rays(mesh, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` as mesh rank 0 holds it, on every rank (a
    broadcast into a copy; the caller's tensors are left as they are)."""
    def bcast(x):
        x = x.contiguous().clone()
        mesh.broadcast(x)
        return x
    return _map(bcast, tree)


def render_sharded(scene, key, cfg, mesh: Mesh) -> torch.Tensor:
    """One sample pass over `mesh`: each rank renders its band of rows
    (render.sample_image's `rows`) and the bands are gathered into the
    whole (H, W, 3) image on every rank.  The gather is an all_reduce
    sum over images that are zero outside each rank's band, so every
    pixel is its rank's value bit for bit.  The scene is replicated: a
    scene-sharded scene walks every ray on every rank, and takes
    render.sample_image."""
    from ..render import sample_image, specialize_config
    if scene.sharded:
        raise ValueError("render_sharded splits the rays over the ranks; a "
                         "scene-sharded scene needs every ray on every rank "
                         "(render.sample_image)")
    cfg = specialize_config(cfg, scene)
    cam = scene.camera
    img = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32,
                      device=scene.device)
    lo, hi = mesh.band(cam.height)
    if hi > lo:
        img[lo:hi] = sample_image(scene, key, cfg, rows=(lo, hi))
    mesh.all_reduce(img)
    return img
