"""Rendezvous from the launcher's environment, from
``audio_residual_tpu/parallel/distributed.py`` (the reference's
`training/distributed.py:24-139`).

:func:`world_info_from_env` reads rank and world size from SLURM, OpenMPI,
PMI or torchrun variables, as the JAX package does. :func:`init_distributed`
joins them on ``torch.distributed`` with one process a card (NCCL on the
card, gloo on the CPU) where the JAX package runs ``jax.distributed`` with
one process a host; the address is ``tcp://`` of the coordinator or of
``MASTER_ADDR:MASTER_PORT``.
"""

from __future__ import annotations

import logging
import os

import torch

__all__ = ["world_info_from_env", "init_distributed"]

_LAUNCHERS = (("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"),
              ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID"),
              ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def world_info_from_env() -> tuple[int, int, str | None]:
    """``(rank, world_size, coordinator)`` from the first launcher whose
    rank and size variables are both set (`distributed.py:43-60`);
    ``(0, 1, None)`` without one. The coordinator is
    ``COORDINATOR_ADDRESS`` or ``MASTER_ADDR``, with ``MASTER_PORT``
    appended when it names no port."""
    for rank_var, size_var, _ in _LAUNCHERS:
        if rank_var in os.environ and size_var in os.environ:
            rank = int(os.environ[rank_var])
            size = int(os.environ[size_var])
            coord = os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("MASTER_ADDR")
            if coord and "MASTER_PORT" in os.environ and ":" not in coord:
                coord = f"{coord}:{os.environ['MASTER_PORT']}"
            return rank, size, coord
    return 0, 1, None


def _local_rank(rank: int) -> int:
    for rank_var, size_var, local_var in _LAUNCHERS:
        if rank_var in os.environ and size_var in os.environ:
            return int(os.environ.get(local_var, rank))
    return rank


def init_distributed(coordinator: str | None = None, *, device: str | None = None) -> dict:
    """Join the world the environment names: one process a card, the card
    of its local rank, NCCL (``device="cpu"``: gloo, no card). A world of
    one initialises nothing. Returns ``{rank, world_size, local_rank,
    device}``."""
    rank, size, env_coord = world_info_from_env()
    coordinator = coordinator or env_coord
    local = _local_rank(rank)
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on gloo")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if size > 1 and not torch.distributed.is_initialized():
        if coordinator is None:
            raise RuntimeError("a world of several processes needs a coordinator address "
                               "(COORDINATOR_ADDRESS or MASTER_ADDR and MASTER_PORT)")
        torch.distributed.init_process_group(
            "gloo" if dev.type == "cpu" else "nccl", init_method=f"tcp://{coordinator}",
            world_size=size, rank=rank)
        logging.info("torch.distributed initialised: rank %d/%d on %s", rank, size, dev)
    return {"rank": rank, "world_size": size, "local_rank": local, "device": dev}

