"""Checkpoint save and resume with top-K rotation, from
``audio_residual_tpu/training/checkpoints.py`` (the reference's
`training/main.py:36-101,429-465,534-570`).

A checkpoint is one ``torch.save`` file in the reference's ``.pt`` layout,
``{"epoch", "name", "state_dict", "optimizer"}`` (the model's state dict in
the reference checkpoint's names, which ``load_clap_checkpoint`` reads, the
optimizer's state dict), plus ``"step"``, the count of updates made. The
JAX package writes orbax
directories beside a json of ``{epoch, name}``; the rotation semantics are
its: ``epoch_{n}.pt``, ``epoch_latest.pt`` (written to a temporary file,
then renamed), ``{base}_{i}.pt`` shifted up by :func:`maintain_ckpts` and
slotted by :func:`update_top_k_performance`. Files are read back with
``weights_only=True``: tensors and plain data only.

A model sharded by ``parallel/fsdp.py`` saves the same file: every rank
gathers the full state dicts (a collective, so every rank calls the save),
rank 0 writes, and the file loads into an unsharded model as well. In a
process group only rank 0 writes, renames and removes files.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from audio_residual_tpu_torch.parallel.fsdp import (full_state_dict, is_sharded,
                                                    load_full_state_dict)

__all__ = ["save_checkpoint", "load_checkpoint", "save_most_recent", "maintain_ckpts",
           "update_top_k_performance", "checkpoint_payload"]


def checkpoint_payload(state: dict, epoch: int = 0, name: str = "") -> dict:
    """The file's content for a train state (:func:`..train_clap.init_train_state`);
    of a sharded model the unsharded state dicts, on rank 0 (empty on the
    others)."""
    model, optimizer = state["model"], state["optimizer"]
    if is_sharded(model):
        model_sd, optim_sd = full_state_dict(model, optimizer)
    else:
        model_sd, optim_sd = model.state_dict(), optimizer.state_dict()
    return {"epoch": epoch, "name": name, "state_dict": model_sd, "optimizer": optim_sd,
            "step": int(state["step"])}


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _write(path: str, payload: dict) -> str:
    if not _writer():
        return path
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(ckpt_dir: str, state: dict, epoch: int, name: str = "") -> str:
    """Write ``epoch_{epoch}.pt``."""
    return _write(os.path.join(ckpt_dir, f"epoch_{epoch}.pt"),
                  checkpoint_payload(state, epoch, name))


def load_checkpoint(path: str, state: dict) -> dict:
    """Restore a checkpoint into ``state``'s model and optimizer (on their
    devices; a sharded model's shards on each rank, which all read the file)
    and its step count; returns ``state``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in ckpt["state_dict"].items()}
    if is_sharded(state["model"]):
        load_full_state_dict(state["model"], state["optimizer"], sd, ckpt.get("optimizer"))
    else:
        state["model"].load_state_dict(sd, strict=True)
        if "optimizer" in ckpt:
            state["optimizer"].load_state_dict(ckpt["optimizer"])
    state["step"] = int(ckpt.get("step", 0))
    return state


def save_most_recent(ckpt_dir: str, state: dict, epoch: int = 0, name: str = "") -> str:
    """Write ``epoch_latest.pt`` (``--save-most-recent``)."""
    return _write(os.path.join(ckpt_dir, "epoch_latest.pt"),
                  checkpoint_payload(state, epoch, name))


def _slot(ckpt_dir: str, base_name: str, i: int) -> str:
    return os.path.join(ckpt_dir, f"{base_name}_{i}.pt")


def maintain_ckpts(ckpt_dir: str, base_name: str, how_many: int) -> None:
    """Shift ``{base}_{i}.pt`` up by one and drop what passes ``how_many``
    (`main.py:36-47`)."""
    if not _writer():
        return
    for i in range(how_many - 1, -1, -1):
        if os.path.exists(_slot(ckpt_dir, base_name, i)):
            os.replace(_slot(ckpt_dir, base_name, i), _slot(ckpt_dir, base_name, i + 1))
    if os.path.exists(_slot(ckpt_dir, base_name, how_many)):
        os.remove(_slot(ckpt_dir, base_name, how_many))


def update_top_k_performance(new_metric: float, current_top_k: dict[int, float],
                             ckpt_dir: str, state: dict, *, bigger_better: bool = True,
                             base_name: str = "pretrain_performance", epoch: int = 0,
                             name: str = "") -> dict[int, float]:
    """Top-K tracker (`main.py:50-101`): where the new metric beats slot k,
    shift slots k.. down by one and save the state into slot k."""
    ranks = sorted(current_top_k)
    for k in ranks:
        best = current_top_k[k]
        if new_metric > best if bigger_better else new_metric < best:
            for i in range(max(ranks), k, -1):
                if _writer() and os.path.exists(_slot(ckpt_dir, base_name, i - 1)):
                    os.replace(_slot(ckpt_dir, base_name, i - 1), _slot(ckpt_dir, base_name, i))
                current_top_k[i] = current_top_k[i - 1]
            _write(_slot(ckpt_dir, base_name, k), checkpoint_payload(state, epoch, name))
            current_top_k[k] = new_metric
            break
    return current_top_k
