"""Process groups for the port's multi-device paths.

The port's counterpart of cutie_tpu/parallel/mesh.py. cutie_tpu drives
every device of a host from one process through a jax Mesh; PyTorch runs
one process (rank) a device, as torchrun launches them, and the ranks talk
through torch.distributed: NCCL between CUDA devices, gloo on the CPU (and
on one card shared by several ranks, which NCCL refuses).

  init_distributed  joins this process to the group torchrun describes
                    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR) and returns
                    the rank's device;
  make_mesh(n)      the group of n ranks this rank belongs to (the world
                    split into consecutive groups of n); raises when the
                    world has fewer ranks, as cutie_tpu's make_mesh does;
  shard_batch       this rank's rows of a host global batch;
  all_gather, all_reduce_sum_  the collectives of the sharded read;
  all_reduce_mean_, broadcast_  coalesced collectives over tensor lists
                    (the data-parallel trainer's gradient average and its
                    parameter broadcast).
A mesh of one rank outside any group (no torch.distributed) makes every
collective the identity.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A group of `size` ranks, this process its `rank`-th member; group
    None is the default (world) group."""
    group: Any
    size: int
    rank: int


def process_rank():
    """(rank, world size) of torch.distributed, or (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device: Optional[str], local_rank: int) -> torch.device:
    """The device of the rank with this local rank: the CPU for 'cpu', the
    local_rank-th card for 'cuda' (or None), the card named otherwise
    ('cuda:0' puts every rank of a host on one card)."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def init_distributed(device: Optional[str] = "cuda", *,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    rank and world_size default to torchrun's RANK and WORLD_SIZE, the
    local rank (which card) to LOCAL_RANK; init_method defaults to
    'env://' (MASTER_ADDR and MASTER_PORT). The backend is NCCL for a CUDA
    device and gloo for the CPU unless given (gloo also takes CUDA tensors:
    several ranks on one card). A failed start raises. When the group
    exists already, only the device is returned."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA device was asked for and "
                               "torch.cuda.is_available() is False; pass device=cpu")
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"init_distributed: rank {rank} wants {dev} but "
                               f"this host has {torch.cuda.device_count()} cards")
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise RuntimeError("init_distributed: MASTER_ADDR is unset (launch with "
                               "torchrun, or pass init_method)")
        init_method = "env://"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The group of n_devices ranks this rank belongs to (all of the world
    by default). The world is split into consecutive groups of n_devices
    ranks; every rank must call this with the same n_devices."""
    rank, world = process_rank()
    n = world if n_devices is None else int(n_devices)
    if world < n:
        # a silent truncation would let an n-rank validation "pass" on one
        # rank without a single collective
        raise ValueError(f"requested a {n}-rank mesh but only {world} ranks are "
                         f"available (start the ranks with torchrun or "
                         f"init_distributed)")
    if world % n:
        raise ValueError(f"a {n}-rank mesh does not divide the {world} ranks")
    if not dist.is_initialized():
        return Mesh(None, 1, 0)
    if n == world:
        return Mesh(None, n, rank)
    # new_subgroups is a collective of the whole world: made once a group
    # size, so that ranks that build meshes unevenly (one a video) agree
    key = (n, id(dist.group.WORLD))
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = dist.new_subgroups(n)[0]
    return Mesh(_SUBGROUPS[key], n, rank % n)


_SUBGROUPS = {}


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> dict:
    """This rank's rows of a host global batch (the leading axis split
    evenly across the mesh, in rank order): the single-process form of a
    sharded upload, for callers that hold the whole batch."""
    out = {}
    for k, x in batch.items():
        b = len(x)
        if b % mesh.size:
            raise ValueError(f"batch {k} of {b} rows does not divide across "
                             f"{mesh.size} ranks")
        local = b // mesh.size
        out[k] = x[mesh.rank * local:(mesh.rank + 1) * local]
    return out


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


# gathered as the integers of their width: a gather moves bits, and not
# every backend takes these dtypes
_GATHER_AS = {torch.bool: torch.uint8, torch.bfloat16: torch.int16}


def all_gather(t: torch.Tensor, mesh: Mesh) -> list:
    """Every mesh rank's `t` (all of one shape), in rank order. The list
    form of all-gather: gloo takes it for CUDA tensors too."""
    if not _grouped():
        return [t]
    dtype = t.dtype
    t = t.contiguous()
    if dtype in _GATHER_AS:
        t = t.view(_GATHER_AS[dtype])
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return [x.view(dtype) for x in out]


def all_reduce_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise sum of every mesh rank's `t`, in place."""
    if _grouped():
        dist.all_reduce(t, group=mesh.group)
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Average each tensor across the mesh, in place, in one all-reduce a
    dtype (the tensors flattened into one buffer)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        all_reduce_sum_(flat, mesh)
        flat /= mesh.size
        for t, avg in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(avg)


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh, src: int = 0) -> None:
    """Overwrite each tensor with the mesh's rank `src`'s, in place, in one
    broadcast a dtype."""
    if not _grouped():
        return
    src_global = dist.get_global_rank(mesh.group, src) if mesh.group else src
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.broadcast(flat, src_global, group=mesh.group)
        for t, value in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(value)
