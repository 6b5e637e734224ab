"""Process bootstrap and the pod-scale meshes.

Counterpart of raytracingrenderer_tpu/parallel/distributed.py.  The JAX
package joins hosts with jax.distributed and builds meshes of their
devices; here every device is a rank of its own (parallel/mesh.py), and
`init_distributed` joins the ranks with torch.distributed.init_process_group,
from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or from its arguments.  A
run of one process needs no process group: `init_distributed` is then a
no-op, as the JAX package's is, and every mesh has one rank.

    torchrun --nproc_per_node 4 -m raytracingrenderer_tpu_torch.cli \\
        -scene DIR -sceneShards 4 -SPP 64

The backend is NCCL for ranks on the card and gloo for ranks on the
CPU.  NCCL takes one rank a card, so ranks that share one card (a test
of the multi-rank paths on a one-card machine) pass backend="gloo" and
device="cuda:0": gloo stages the card's tensors through the host.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.log import get_logger
from .mesh import RAY_AXIS, Mesh, make_mesh

_log = get_logger("dist")
HOST_AXIS = "hosts"
TIMEOUT_S = 60.0

# the device this process's rank drives, once init_distributed named it
_device: Optional[torch.device] = None


def rank_device() -> torch.device:
    """This rank's device: the one init_distributed chose, else the
    current card where there is one, else the CPU."""
    if _device is not None:
        return _device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _choose_device(device, rank: int) -> torch.device:
    """The device a rank drives: the one named, where it names a card's
    index or the CPU, else ("cuda" or None) the card LOCAL_RANK names.
    A rank asked for the card where there is none raises: only a caller
    that names the CPU gets the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"rank {rank} asked for device {str(dev)!r}, but "
            f"torch.cuda.is_available() is false; pass device='cpu' (the "
            f"CLI's -device cpu) for gloo ranks on the CPU")
    if dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK", rank)
    count = torch.cuda.device_count()
    if not 0 <= local < count:
        raise ValueError(
            f"LOCAL_RANK {local} has no card of its own ({count} visible): "
            f"start at most {count} ranks a host, or name the device "
            f"(ranks that share a card need backend='gloo')")
    return torch.device("cuda", local)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """Join this process to its ranks; True where this call made the
    process group.

    The world size and rank come from the arguments, else from torchrun's
    WORLD_SIZE and RANK; a world of one process makes no group (no-op).
    `coordinator` is the rendezvous: "tcp://host:port", "host:port" or
    "file:///path" (default: torchrun's MASTER_ADDR / MASTER_PORT).  The
    rank drives `device` (default "cuda": the card LOCAL_RANK names, which
    must exist; "cpu" only where asked for), made current on the card;
    `backend` defaults to "nccl" on the card and "gloo" on the CPU.
    TIMEOUT_S bounds init and every collective, so a rank that is gone
    fails the others instead of hanging them."""
    global _device
    if dist.is_initialized():
        return False
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE", 1)
    if world is None or world <= 1:
        _log.debug("single-process mode: no process group")
        return False
    rank = process_id if process_id is not None else _env_int("RANK", None)
    if rank is None:
        raise ValueError(f"a world of {world} processes needs this "
                         f"process's rank (process_id, or torchrun's RANK)")
    dev = _choose_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _device = dev
    _log.debug("rank %d of %d on %s (%s)", rank, world, dev, backend)
    return True


def pod_mesh() -> Mesh:
    """The flat `rays` mesh over every rank of every host: rays shard
    with no collectives, so one axis as long as possible is best; the
    (hosts, local ranks) grid matters only to an operation that needs a
    host's ranks alone (`host_chip_mesh`)."""
    return make_mesh()


@dataclasses.dataclass(frozen=True, eq=False)
class HostChipMesh:
    """(hosts, local ranks) grid: `local` is the `rays` mesh of this
    host's ranks (NVLink within a host), `cross` the `hosts` mesh of the
    ranks with this one's local index on every host (the network across
    hosts); `shape` = (hosts, local ranks), `host` this rank's row."""
    shape: Tuple[int, int]
    host: int
    local: Mesh
    cross: Mesh
    axis_names = (HOST_AXIS, RAY_AXIS)


def host_chip_mesh(per_host: Optional[int] = None) -> HostChipMesh:
    """The (hosts, local ranks) grid over every rank: ranks
    [h * per_host, (h + 1) * per_host) are host h (torchrun numbers
    them so), per_host from LOCAL_WORLD_SIZE by default.  One subgroup a
    host and one a local index; every rank must call this together."""
    dev = rank_device()
    if not dist.is_initialized():
        one = make_mesh(1, dev)
        return HostChipMesh((1, 1), 0, one, one)
    world, rank = dist.get_world_size(), dist.get_rank()
    per_host = per_host or _env_int("LOCAL_WORLD_SIZE", world)
    if world % per_host:
        raise ValueError(f"{world} ranks do not make hosts of {per_host}")
    hosts = world // per_host
    by_host = [list(range(h * per_host, (h + 1) * per_host))
               for h in range(hosts)]
    by_local = [list(range(i, world, per_host)) for i in range(per_host)]
    local_group, _ = dist.new_subgroups_by_enumeration(by_host)
    cross_group, _ = dist.new_subgroups_by_enumeration(by_local)
    host, local_rank = divmod(rank, per_host)
    return HostChipMesh(
        (hosts, per_host), host,
        Mesh(local_group, local_rank, per_host, dev),
        Mesh(cross_group, host, hosts, dev))
