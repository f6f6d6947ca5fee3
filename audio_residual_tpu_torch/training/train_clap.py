"""Contrastive CLAP pretraining and finetuning: the train step, the
optimizers and their groups, from ``audio_residual_tpu/training/train_clap.py``
(the reference's `training/main.py` + `training/train.py`).

The JAX package's step is one jitted function of ``(state, batch, rng)``;
here ``state`` is ``{"model", "optimizer", "step"}`` (:func:`init_train_state`),
updated in place, and the randomness comes from a ``torch.Generator``. On the
card the towers' forward runs the kernels (K1, K4 in the blocks without
drop-path, K2/K5 in the others; RoBERTa's AMP products on the bf16 GEMM) and
the backward re-runs their plain versions under autograd
(:mod:`audio_residual_tpu_torch.ops.cuda.autograd`).

Optimizer groups as the reference's (`main.py:283-309`): no weight decay for
parameters of fewer than two dimensions (biases, LN and BN scales, the logit
scales). The decay is decoupled (AdamW), applied to every decayed parameter
at every step, a parameter without a gradient in this step too, as optax's
``add_decayed_weights`` does: the step gives such a parameter a zero
gradient. Each param group carries its schedule's numbers (``base_lr``,
``warmup``, ``total_steps``, ``skip_scheduler``), so its state dict is plain
data; :func:`set_lrs` sets the groups' rates for a step.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from audio_residual_tpu_torch.parallel.fsdp import (SHARDED_GROUP_SUFFIX, average_replicated_grads,
                                                    is_sharded)
from audio_residual_tpu_torch.training.losses import clip_loss
from audio_residual_tpu_torch.training.scheduler import cosine_lr
from audio_residual_tpu_torch.utils.misc import do_mixup
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = ["MAX_LOGIT_SCALE", "decay_mask", "is_text_param", "is_pretrained_param",
           "make_optimizer", "make_split_optimizer", "set_lrs", "init_train_state",
           "ClapTowers", "make_train_step", "grad_norm"]

MAX_LOGIT_SCALE = math.log(100.0)

# the text side's parameters: the CLIP text tower keeps its embeddings and
# ln_final on the model's root (the reference checkpoint's layout), where the
# JAX package keeps them in text_branch
TEXT_PREFIXES = ("text_branch.", "token_embedding", "positional_embedding", "ln_final.")


def is_text_param(name: str) -> bool:
    return name.startswith(TEXT_PREFIXES)


def is_pretrained_param(name: str) -> bool:
    """The towers (loaded from a checkpoint) against the new projections,
    transforms and logit scales (``is_pretrained_params``, `main.py:109`)."""
    return name.startswith("audio_branch.") or is_text_param(name)


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """True where weight decay applies: parameters of two or more
    dimensions (`main.py:283-309`)."""
    return {name: p.ndim >= 2 for name, p in model.named_parameters()}


def _groups(named, *, label: str, lr: float, weight_decay: float, warmup: int,
            total_steps: int, skip_scheduler: bool, **extra) -> list[dict]:
    """The decayed and the undecayed parameters, each split once more into
    plain and sharded ones (``DTensor``, ``parallel/fsdp.py``): a foreach
    update takes no mix of the two. A checkpoint merges the split back
    (``fsdp.full_state_dict``), so its file is the unsharded model's."""
    sched = dict(lr=lr, base_lr=lr, warmup=warmup, total_steps=total_steps,
                 skip_scheduler=skip_scheduler, **extra)
    groups = []
    for kind, decayed, wd in (("decay", True, weight_decay), ("no_decay", False, 0.0)):
        for sharded in (False, True):
            params = [p for _, p in named
                      if (p.ndim >= 2) == decayed and isinstance(p, DTensor) == sharded]
            if params:
                groups.append({"params": params, "weight_decay": wd,
                               "label": f"{label}/{kind}" + (SHARDED_GROUP_SUFFIX if sharded else ""),
                               **sched})
    return groups


def _optimizer(name: str, groups: list[dict]) -> torch.optim.Optimizer:
    """``--optimizer`` (`clap_module/utils.py:374-389`): adamw, adam (the
    reference forces its decay to 0, `main.py:312-314`), sgd (heavy-ball
    momentum, no decay)."""
    if name == "sgd":
        for g in groups:
            g["weight_decay"] = 0.0
            for k in ("betas", "eps"):
                g.pop(k, None)
        return torch.optim.SGD(groups, lr=groups[0]["lr"])
    if name == "adam":
        for g in groups:
            g["weight_decay"] = 0.0
    elif name != "adamw":
        raise ValueError("optimizer name is not correct")
    for g in groups:
        g.pop("momentum", None)
    return torch.optim.AdamW(groups, lr=groups[0]["lr"])


def make_optimizer(model: nn.Module, lr: float = 1e-4, *, beta1: float = 0.99,
                   beta2: float = 0.9, eps: float = 1e-8, weight_decay: float = 0.0,
                   warmup: int = 3200, total_steps: int = 100000, name: str = "adamw",
                   momentum: float = 0.9, skip_scheduler: bool = False
                   ) -> torch.optim.Optimizer:
    """The ``--optimizer`` mux with the cosine-warmup schedule and the decay
    mask (``make_optimizer`` of the JAX package: AdamW betas default to
    HTSAT's ``get_default_params``; ``skip_scheduler`` holds the base
    rate)."""
    named = list(model.named_parameters())
    groups = _groups(named, label="all", lr=lr, weight_decay=weight_decay, warmup=warmup,
                     total_steps=total_steps, skip_scheduler=skip_scheduler,
                     betas=(beta1, beta2), eps=eps, momentum=momentum)
    return _optimizer(name, groups)


def make_split_optimizer(model: nn.Module, *, lr_pretrained: float = 1e-5,
                         lr_new: float = 1e-4, weight_decay_pretrained: float = 0.2,
                         weight_decay_new: float = 0.2, warmup: int = 3200,
                         total_steps: int = 100000, is_pretrained=None,
                         betas=(0.9, 0.999), eps: float = 1e-8, betas_pretrained=None,
                         betas_new=None, eps_pretrained: float | None = None,
                         eps_new: float | None = None, name: str = "adamw",
                         momentum_pretrained: float = 0.9, momentum_new: float = 0.9,
                         skip_scheduler: bool = False) -> torch.optim.Optimizer:
    """Separate groups for pretrained and new parameters, the ``--split-opt``
    regime (`main.py:323-404`). ``is_pretrained(name) -> bool`` labels each
    parameter (default :func:`is_pretrained_param`); per-group betas and eps
    fall back to the shared ones."""
    is_pretrained = is_pretrained or is_pretrained_param
    named = list(model.named_parameters())
    groups = []
    for label, lr, wd, bg, eg, mom in (
            ("pretrained", lr_pretrained, weight_decay_pretrained, betas_pretrained,
             eps_pretrained, momentum_pretrained),
            ("new", lr_new, weight_decay_new, betas_new, eps_new, momentum_new)):
        part = [(n, p) for n, p in named if is_pretrained(n) == (label == "pretrained")]
        groups += _groups(part, label=label, lr=lr, weight_decay=wd, warmup=warmup,
                          total_steps=total_steps, skip_scheduler=skip_scheduler,
                          betas=tuple(bg or betas), eps=eg if eg is not None else eps,
                          momentum=mom)
    return _optimizer(name, groups)


def set_lrs(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Each group's rate for the update after ``step`` updates."""
    for g in optimizer.param_groups:
        g["lr"] = (g["base_lr"] if g["skip_scheduler"]
                   else cosine_lr(g["base_lr"], g["warmup"], g["total_steps"])(step))


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """``{"model", "optimizer", "step"}``, the model's parameters made
    trainable."""
    model.requires_grad_(True)
    return {"model": model, "optimizer": optimizer, "step": 0}


class ClapTowers(nn.Module):
    """The dual-tower training forward as a module, so that
    ``DistributedDataParallel`` can wrap it: ``forward(waveform, input_ids,
    attention_mask, seed)`` is ``clap_apply(train=True)`` with a generator on
    the model's device seeded from ``seed`` (None: no randomness). With
    ``remat`` the forward runs under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the activations instead of
    keeping them, with the same draws, since the generator is made again
    from its seed; the gradients are exact."""

    def __init__(self, model: nn.Module, *, compute_dtype=None, remat: bool = False,
                 bn_group=None):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.bn_group = bn_group

    def _forward(self, waveform, input_ids, attention_mask, seed):
        dev = self.model.logit_scale_a.device
        gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
        return self.model({"waveform": waveform}, input_ids, attention_mask, train=True,
                          generator=gen, bn_group=self.bn_group,
                          compute_dtype=self.compute_dtype)

    def forward(self, waveform, input_ids, attention_mask=None, seed: int | None = None):
        if self.remat:
            from torch.utils.checkpoint import checkpoint

            return checkpoint(self._forward, waveform, input_ids, attention_mask, seed,
                              use_reentrant=False)
        return self._forward(waveform, input_ids, attention_mask, seed)


def grad_norm(params) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients (optax's
    ``global_norm``). A sharded gradient (``DTensor``) counts in full: its
    shards' squares are summed over its mesh."""
    grads = [p.grad for p in params if p.grad is not None]
    plain = [g for g in grads if not isinstance(g, DTensor)]
    sharded = [g for g in grads if isinstance(g, DTensor)]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(plain)))
    if not sharded:
        return norm
    sq = torch.stack(torch._foreach_norm([g.to_local() for g in sharded])).square().sum()
    dist.all_reduce(sq, group=sharded[0].device_mesh.get_group())
    return (norm.square() + sq).sqrt()


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, *,
                    mlp_loss: bool = False, compute_dtype=None, freeze_text: bool = False,
                    mixup_alpha: float = 0.0, remat: bool = False,
                    weight_loss_kappa: float = 0.0, mesh=None, fsdp_mesh=None) -> Callable:
    """``step(state, batch, generator=None) -> (state, metrics)``.

    ``batch``: ``{"waveform" [B, T], "input_ids" [B, L], "attention_mask"
    [B, L]}`` on the model's device (and ``"mixup_lambda" [B]`` for mixup).
    One step: the towers' training forward (:class:`ClapTowers`), the CLIP
    loss, the backward, a zero gradient for each parameter the loss does
    not reach, the text gradients zeroed under ``freeze_text``, the rates of
    this step (:func:`set_lrs`), the optimizer's update, the logit scales
    clamped to ln(100) (`train.py:154-159`) and bn0's running statistics
    replaced by the forward's ``bn0_state``; under a profiler the spans
    ``train.forward``, ``train.loss``, ``train.backward`` and
    ``train.update`` (from the zero-fill to bn0's merge). ``metrics``: ``loss``,
    ``logit_scale_a`` (after the clamp) and ``grad_norm`` (of the gradients
    the update took).

    ``mesh`` (:func:`audio_residual_tpu_torch.parallel.mesh.data_parallel_mesh`)
    of several ranks runs the step data-parallel: each rank feeds its shard
    of the batch (:func:`~audio_residual_tpu_torch.parallel.mesh.shard_batch`)
    through ``DistributedDataParallel``, the loss gathers the features of
    every rank and bn0 takes its statistics over every rank, so the step is
    the single-process step of the whole batch.

    ``fsdp_mesh`` (:func:`audio_residual_tpu_torch.parallel.fsdp.fsdp_mesh`),
    in place of ``mesh``, runs the same step on a model that
    :func:`~audio_residual_tpu_torch.parallel.fsdp.shard_model` sharded
    before ``optimizer`` was built: FSDP gathers the weights around the
    model's forward and backward and reduce-scatters their gradients, the
    replicated parameters' gradients are averaged over the ranks, and the
    update runs on the shards."""
    if mesh is not None and fsdp_mesh is not None:
        raise ValueError("pass mesh (data parallel) or fsdp_mesh (sharded), not both")
    dp = fsdp_mesh or mesh
    group = dp.group if dp is not None and dp.world_size > 1 else None
    towers: nn.Module = ClapTowers(model, compute_dtype=compute_dtype, remat=remat,
                                   bn_group=group)
    if fsdp_mesh is not None:
        if not is_sharded(model):
            raise ValueError("fsdp_mesh needs a model sharded by parallel.fsdp.shard_model "
                             "before its optimizer is built")
    elif group is not None:
        from audio_residual_tpu_torch.parallel.mesh import replicate

        towers = replicate(mesh, towers)
    # taken after sharding, which replaces each sharded parameter
    named = list(model.named_parameters())
    params = [p for _, p in named]
    text = [p for n, p in named if is_text_param(n)]
    bn0 = model.audio_branch.bn0

    def step(state: dict, batch: dict, generator: torch.Generator | None = None):
        wav = batch["waveform"]
        if mixup_alpha and "mixup_lambda" in batch:
            # waveform-level mixup (`utils.py:196-208`, --mixup)
            wav = do_mixup(wav, batch["mixup_lambda"])
        seed = None
        if generator is not None:
            seed = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device))
        with annotate("train.forward"):
            out = towers(wav, batch["input_ids"], batch.get("attention_mask"), seed)
        with annotate("train.loss"):
            loss = clip_loss(out, group=group, mlp_loss=mlp_loss,
                             weight_loss_kappa=weight_loss_kappa)
        optimizer.zero_grad(set_to_none=True)
        with annotate("train.backward"):
            loss.backward()
        with torch.no_grad(), annotate("train.update"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if fsdp_mesh is not None and group is not None:
                average_replicated_grads(params, group)
            if freeze_text:
                for p in text:
                    p.grad.zero_()
            norm = grad_norm(params)
            set_lrs(optimizer, state["step"])
            optimizer.step()
            model.logit_scale_a.clamp_(max=MAX_LOGIT_SCALE)
            model.logit_scale_t.clamp_(max=MAX_LOGIT_SCALE)
            if "bn0_state" in out:
                bn0.running_mean.copy_(out["bn0_state"]["mean"])
                bn0.running_var.copy_(out["bn0_state"]["var"])
        state["step"] += 1
        return state, {"loss": loss.detach(), "logit_scale_a": model.logit_scale_a.detach().clone(),
                       "grad_norm": norm}

    return step
