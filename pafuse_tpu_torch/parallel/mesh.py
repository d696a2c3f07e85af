"""Data parallelism over ``torch.distributed``: the port's parallel layer.

Counterpart of ``pafuse_tpu/parallel/mesh.py``.  JAX expresses data
parallelism as SPMD over a 1-D ``data`` mesh: the batch axis sharded,
parameters and optimizer state replicated, the gradient all-reduce
inserted by XLA.  Here the same layout is one process per card:

* :func:`make_mesh` joins the launcher's process group (``torchrun``'s
  ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, torch.distributed's launch
  contract) over NCCL on CUDA or gloo on the CPU, each rank on
  ``cuda:LOCAL_RANK``; without a launcher it is a world of one with no
  process group.
* Every rank assembles the same global batch (the samplers are seeded
  alike) and keeps its own rows (:func:`shard_rows`), as ``shard_batch``
  ships each device only its shard.
* :func:`replicate` wraps the model in ``DistributedDataParallel``, which
  averages the gradients over the ranks; every rank then takes the same
  AdamW step, so the replicas stay equal bit for bit.
* :func:`gather_rows` puts the ranks' rows back together in rank order
  (evaluation gathers its predictions so that every rank computes the
  batch's metrics as one process would).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from pafuse_tpu_torch.utils.device import resolve_device

#: how long a collective (and joining the group) may wait for a peer before
#: it raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the data-parallel world: its ``rank`` of
    ``size``, its ``device``, and whether a process group is up
    (``distributed``; a world of one without a launcher has none)."""
    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    @property
    def main(self) -> bool:
        """Rank 0: the one rank that writes files."""
        return self.rank == 0


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",),
              device="cuda") -> World:
    """The data-parallel world of this process.

    Under a launcher (``RANK`` and ``WORLD_SIZE`` set) it joins the process
    group (NCCL for a CUDA ``device``, each rank on ``cuda:LOCAL_RANK``;
    gloo for the CPU) with :data:`TIMEOUT`; otherwise it is a world of one
    on ``device``.  ``mesh_shape`` is ``(-1,)`` (the whole world) or the
    world's size; ``axis_names`` is ``("data",)``: the port shards the
    batch and nothing else."""
    if tuple(axis_names) != ("data",):
        raise ValueError(f"mesh_axis_names must be ['data'] (data "
                         f"parallelism only); got {list(axis_names)}")
    if len(mesh_shape) != 1:
        raise ValueError(f"mesh_shape must be one axis, [-1] or [world "
                         f"size]; got {list(mesh_shape)}")
    dev = resolve_device(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    size = int(os.environ["WORLD_SIZE"]) if launched else 1
    if int(mesh_shape[0]) not in (-1, size):
        raise ValueError(f"mesh_shape {list(mesh_shape)} does not match the "
                         f"world of {size} process(es); use [-1]")
    if not launched:
        return World(device=dev)
    rank = int(os.environ["RANK"])
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", rank=rank, world_size=size,
                            timeout=TIMEOUT)
    return World(rank, size, dev, True)


def close(world: World) -> None:
    """Leave the process group (no-op in a world without one)."""
    if world.distributed:
        dist.destroy_process_group()


def broadcast_object(obj, world: World):
    """Rank 0's ``obj`` (picklable) on every rank."""
    if not world.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def per_rank_batch(seqs: int, world: World) -> int:
    """Sequences each rank takes of a step of ``seqs``: the global batch is
    rounded to whole shards as the JAX CLI rounds it, ``max(n, (seqs // n)
    * n)`` for n ranks, so this is ``max(1, seqs // n)``."""
    return max(1, int(seqs) // world.size)


def shard_rows(arrays, world: World):
    """This rank's rows of each array of a global batch (the leading axis
    split into ``world.size`` equal, consecutive shards, in rank order)."""
    out = []
    for a in arrays:
        n = a.shape[0]
        if n % world.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{world.size} ranks")
        k = n // world.size
        out.append(a[world.rank * k:(world.rank + 1) * k])
    return out


def gather_rows(t: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated in rank order along
    the leading axis (``t`` itself without a process group)."""
    if not world.distributed:
        return t
    parts = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def all_mean(t: torch.Tensor, world: World) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``t`` itself without a process
    group)."""
    if not world.distributed:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t / world.size


class TrainForward(nn.Module):
    """A module whose ``forward`` is ``model.train_forward``: DDP hooks the
    gradient all-reduce only through ``forward()``, and ``D3DP`` trains
    through ``train_forward``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.train_forward(*args, **kwargs)


def replicate(model: nn.Module, world: World):
    """``model`` behind ``DistributedDataParallel`` (through
    :class:`TrainForward`): calling it runs ``model.train_forward`` and the
    backward all-reduces and averages the gradients.  Buffers are not
    broadcast (the diffusion tables are constants), and every parameter
    gets a gradient on every step, so unused parameters are not searched
    for."""
    from torch.nn.parallel import DistributedDataParallel
    if not world.distributed:
        raise ValueError("replicate needs a process group (make_mesh under "
                         "a launcher)")
    return DistributedDataParallel(TrainForward(model), device_ids=None,
                                   broadcast_buffers=False,
                                   find_unused_parameters=False)
