"""FSDP (ZeRO-3) sharding of the parameters, gradients and optimizer state
over the data mesh, from ``audio_residual_tpu/parallel/fsdp.py``.

The JAX package places each large leaf of the train state split over the
1-D data mesh and lets GSPMD all-gather the weights where they are used and
reduce-scatter the gradients. Here the same shape rule (:func:`fsdp_spec`)
picks each parameter's placement for PyTorch's composable FSDP
(``torch.distributed.fsdp.fully_shard``): a sharded parameter becomes a
``DTensor`` of ``Shard(d)``, all-gathered around the model's forward and
again for its backward, its gradient reduce-scattered and averaged over the
ranks. Adam's moments mirror their parameters, so an optimizer built after
:func:`shard_model` holds them on the same shards. The leaves the rule
replicates (biases, LN and BN vectors, the 0-d logit scales, which
``fully_shard`` refuses) stay plain tensors, FSDP's ``ignored_params``,
broadcast from rank 0; the train step averages their gradients with one
all-reduce (:func:`average_replicated_grads`).

Differences by design: ``constrain_tree`` has no counterpart, since FSDP's
reduce-scatter is what the in-jit sharding constraint asks GSPMD for; and a
world of one process still shards, over a group of one (:func:`fsdp_mesh`),
so one card runs the path several cards run.

Usage::

    mesh = fsdp_mesh(device)
    shard_model(model, mesh)                            # before the optimizer
    optimizer = make_optimizer(model)
    step = make_train_step(model, optimizer, fsdp_mesh=mesh)   # train_clap.py
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from audio_residual_tpu_torch.parallel.mesh import DataParallelMesh, data_parallel_mesh

__all__ = ["MIN_SHARD_ELEMS", "fsdp_spec", "fsdp_mesh", "shard_model", "is_sharded",
           "average_replicated_grads", "full_state_dict", "load_full_state_dict"]

# Leaves smaller than this stay replicated: the all-gather latency for a
# tiny tensor costs more than the bytes saved (biases, LN/BN vectors,
# logit scales). 2^14 f32 = 64 KiB.
MIN_SHARD_ELEMS = 2 ** 14


def fsdp_spec(shape, n_devices: int, axis: str = "data",
              min_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The placement of one tensor, as ``tuple()`` of the JAX package's
    ``PartitionSpec``: ``axis`` on the largest dim the mesh size divides, for
    a tensor of two or more dims and at least ``min_elems`` elements;
    ``()`` (replicated) otherwise."""
    if len(shape) < 2 or int(np.prod(shape)) < min_elems:
        return ()
    divisible = [d for d in range(len(shape)) if shape[d] % n_devices == 0]
    if not divisible:
        return ()
    best = max(divisible, key=lambda d: shape[d])
    return tuple(axis if d == best else None for d in range(len(shape)))


def fsdp_mesh(device) -> DataParallelMesh:
    """The mesh FSDP shards over on ``device``: the initialised world, or,
    without one, a process group of this process alone (NCCL on a card,
    gloo on the CPU), since ``fully_shard`` needs a group."""
    device = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group("gloo" if device.type == "cpu" else "nccl",
                                store=dist.HashStore(), rank=0, world_size=1)
    return data_parallel_mesh(device=device)


def is_sharded(model: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def shard_model(model: nn.Module, mesh: DataParallelMesh) -> nn.Module:
    """Shard ``model``'s parameters in place by :func:`fsdp_spec` over
    ``mesh`` (:func:`fsdp_mesh`) and return it. Every parameter and buffer
    is first broadcast from rank 0; the rule's replicated leaves stay plain
    tensors. Call it before the optimizer is built, and take parameter
    handles after it: ``fully_shard`` replaces each sharded ``nn.Parameter``.
    The weights are gathered around ``model``'s ``forward``, so the caller
    runs the model through its forward (``CLAP.forward``) and not through
    functions of its submodules."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import fully_shard

    if mesh.group is None:
        raise ValueError("shard_model needs the process group of fsdp_mesh()")
    if mesh.world_size > 1:
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t, 0, group=mesh.group)
    placement, replicated = {}, set()
    for p in model.parameters():
        spec = fsdp_spec(tuple(p.shape), mesh.world_size)
        if spec:
            placement[p] = Shard(spec.index("data"))
        else:
            replicated.add(p)
    fully_shard(model, mesh=DeviceMesh.from_group(mesh.group, mesh.device.type),
                reshard_after_forward=True, shard_placement_fn=placement.__getitem__,
                ignored_params=replicated)
    return model


def average_replicated_grads(params, group) -> None:
    """Average the gradients of the plain (replicated) parameters over
    ``group`` with one all-reduce of their concatenation; FSDP's
    reduce-scatter averages the sharded ones."""
    grads = [p.grad for p in params if p.grad is not None and not isinstance(p, DTensor)]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


# The label suffix of a parameter group that ``training/train_clap.py``
# splits off by placement (sharded ``DTensor``s apart from plain tensors,
# since a foreach update takes no mix of the two); a checkpoint merges it
# back into its plain twin.
SHARDED_GROUP_SUFFIX = "/sharded"


def _layout(model: nn.Module, optimizer: torch.optim.Optimizer
            ) -> list[tuple[dict, list[str], list[dict]]]:
    """The optimizer's parameter groups as the optimizer of the unsharded
    model has them: each group split off by placement merged back into its
    plain twin (in the place of the first of the two), its parameters in
    ``named_parameters()`` order. ``[(hyperparameters, names, live groups)]``;
    an optimizer without such a split gives its own groups."""
    order = {id(p): (i, n) for i, (n, p) in enumerate(model.named_parameters())}
    merged: dict = {}
    for g in optimizer.param_groups:
        label = g.get("label")
        key = label.removesuffix(SHARDED_GROUP_SUFFIX) if isinstance(label, str) else id(g)
        if key not in merged:
            hyper = {k: v for k, v in g.items() if k != "params"}
            if isinstance(label, str):
                hyper["label"] = key
            merged[key] = (hyper, [], [])
        merged[key][1].extend(order[id(p)] for p in g["params"])
        merged[key][2].append(g)
    return [(hyper, [n for _, n in sorted(members)], live)
            for hyper, members, live in merged.values()]


def full_state_dict(model: nn.Module, optimizer: torch.optim.Optimizer | None = None
                    ) -> tuple[dict, dict | None]:
    """The unsharded ``(model state dict, optimizer state dict)`` of a
    sharded model, gathered on every rank (a collective) and kept on rank 0
    only, on the CPU (where the model lies on the CPU, its unsharded tensors
    themselves: copy them before a further step); the other ranks get empty
    dicts. Both are what the unsharded model and its optimizer's
    ``state_dict()`` give, whatever the placement: the optimizer's groups
    merged back as :func:`_layout` says, its state keyed by integer ids in
    their order."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    if optimizer is None:
        from torch.distributed.checkpoint.state_dict import get_model_state_dict

        return get_model_state_dict(model, options=opts), None
    model_sd, optim_sd = get_state_dict(model, optimizer, options=opts)
    if not optim_sd:
        return model_sd, optim_sd
    layout = _layout(model, optimizer)
    ids = {n: i for i, n in enumerate(n for _, names, _ in layout for n in names)}
    return model_sd, {"state": {ids[n]: optim_sd["state"][n] for n in ids
                                if n in optim_sd["state"]},
                      "param_groups": [{**hyper, "params": [ids[n] for n in names]}
                                       for hyper, names, _ in layout]}


def load_full_state_dict(model: nn.Module, optimizer: torch.optim.Optimizer | None,
                         model_sd: dict, optim_sd: dict | None = None) -> None:
    """Load unsharded state dicts (of :func:`full_state_dict`, or an
    unsharded model's and optimizer's ``state_dict()``, which every rank
    passes in full) into a sharded model and its optimizer: each rank keeps
    its shards. The file's groups are matched to :func:`_layout`'s in order,
    as ``Optimizer.load_state_dict`` matches them, and each integer id to
    the name of the parameter in its place; a group split by placement takes
    the hyperparameters of the file's group and keeps its own label."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                         set_model_state_dict,
                                                         set_optimizer_state_dict)

    opts = StateDictOptions(full_state_dict=True, strict=True)
    set_model_state_dict(model, model_sd, options=opts)
    if optimizer is None or optim_sd is None:
        return
    layout = _layout(model, optimizer)
    saved = optim_sd["param_groups"]
    if [len(g["params"]) for g in saved] != [len(names) for _, names, _ in layout]:
        raise ValueError("the checkpoint's optimizer has other parameter groups than this "
                         f"one: {[len(g['params']) for g in saved]} parameters a group "
                         f"against {[len(names) for _, names, _ in layout]}")
    name = {i: n for g, (_, names, _) in zip(saved, layout) for i, n in zip(g["params"], names)}
    hyper = {}
    for g, (_, _, live) in zip(saved, layout):
        for own in live:
            hyper[id(own)] = {**{k: v for k, v in g.items() if k != "params"},
                              **({"label": own["label"]} if "label" in own else {})}
    hypers = [hyper[id(own)] for own in optimizer.param_groups]
    fqn = {id(p): n for n, p in model.named_parameters()}
    set_optimizer_state_dict(
        model, optimizer, options=opts,
        optim_state_dict={"state": {name[i]: s for i, s in optim_sd["state"].items()},
                          "param_groups": [{**h, "params": [fqn[id(p)] for p in own["params"]]}
                                           for h, own in zip(hypers, optimizer.param_groups)]})
    # DCP's flattening turns tuples (AdamW's betas) into lists: the file's
    # values as they are, in the groups' order, which loading keeps
    for own, h in zip(optimizer.param_groups, hypers):
        own.update(h)
