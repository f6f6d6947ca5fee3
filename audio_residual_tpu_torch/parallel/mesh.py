"""Data parallelism, from ``audio_residual_tpu/parallel/mesh.py``.

The JAX package runs one program over a 1-D ``Mesh("data")``: parameters
replicated, the batch sharded, XLA's collectives between. Here the mesh is a
``torch.distributed`` process group with one process a card
(:func:`data_parallel_mesh`); :func:`replicate` wraps a module in
``DistributedDataParallel`` (parameters broadcast from rank 0, gradients
averaged over the ranks), and :func:`shard_batch` gives each rank its rows
of the global batch on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["DataParallelMesh", "data_parallel_mesh", "replicate", "shard_batch"]


@dataclass(frozen=True)
class DataParallelMesh:
    """The ranks of one data-parallel group and this process's place in it."""

    group: object
    rank: int
    world_size: int
    device: torch.device


def data_parallel_mesh(n_devices: int | None = None, *, device=None) -> DataParallelMesh:
    """The world of the initialised process group (one process, no group,
    without one) on this process's ``device`` (default: the current card).
    ``n_devices`` must equal the world's size: a smaller mesh would fake
    multi-card coverage."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"data_parallel_mesh({n_devices}) needs a world of {n_devices} "
                         f"processes, one a card; this one has {size}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu'")
        device = torch.device("cuda", torch.cuda.current_device())
    return DataParallelMesh(group, rank, size, torch.device(device))


def replicate(mesh: DataParallelMesh, module: nn.Module) -> nn.Module:
    """``module`` replicated over the mesh: ``DistributedDataParallel`` (a
    world of one: the module itself). Parameters a step does not reach are
    found each step (the unused tower heads), and buffers are not
    broadcast (the train step writes the same bn0 statistics on every
    rank)."""
    if mesh.world_size == 1:
        return module
    from torch.nn.parallel import DistributedDataParallel

    ids = [mesh.device.index] if mesh.device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=ids, process_group=mesh.group,
                                   find_unused_parameters=True, broadcast_buffers=False)


def shard_batch(mesh: DataParallelMesh, tree):
    """This rank's rows of every leaf of a global batch (a dict of arrays or
    tensors with the batch on axis 0, which the world size divides), on the
    mesh's device."""
    def shard(x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"batch of {n} rows does not split over {mesh.world_size} ranks")
        per = n // mesh.world_size
        return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)

    return {k: shard(v) for k, v in tree.items()}
