"""Workers of the port's multi-process tests: each runs in its own process
(``spawn``), joins a gloo group on ``localhost`` and writes its results to
``out/rank{r}.pt``. Imports torch and the port only."""

from __future__ import annotations

import os
import socket

import torch
import torch.nn.functional as F

TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, target: str, out: str, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        result = globals()[target](rank, world, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(target: str, world: int, out: str, *args) -> list:
    """Run ``target(rank, world, *args)`` in ``world`` processes; their
    results in rank order. Raises when a process fails or outlives
    ``TIMEOUT_S``."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, world, port, target, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    if alive or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{target}: exit codes {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


class FeatureTowers(torch.nn.Module):
    """Two linear towers and their MLP heads, with CLAP's logit scales: a
    model small enough to hold the sharded loss's gradients against one
    process's."""

    def __init__(self, d_in: int = 12, d: int = 8, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        for name in ("audio", "text", "audio_mlp", "text_mlp"):
            lin = torch.nn.Linear(d_in if name in ("audio", "text") else d, d)
            with torch.no_grad():
                lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.3)
                lin.bias.copy_(torch.randn(lin.bias.shape, generator=g) * 0.1)
            setattr(self, name, lin)
        self.logit_scale_a = torch.nn.Parameter(torch.tensor(2.0))
        self.logit_scale_t = torch.nn.Parameter(torch.tensor(2.5))

    def forward(self, xa, xt):
        a = F.normalize(self.audio(xa), dim=-1)
        t = F.normalize(self.text(xt), dim=-1)
        return {"audio_features": a, "text_features": t,
                "audio_features_mlp": self.audio_mlp(a), "text_features_mlp": self.text_mlp(t),
                "logit_scale_a": self.logit_scale_a.exp(),
                "logit_scale_t": self.logit_scale_t.exp()}


def feature_inputs(n: int = 8, d_in: int = 12, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d_in, generator=g), torch.randn(n, d_in, generator=g)


LOSS_CASES = [(mlp, local) for mlp in (False, True) for local in (False, True)]


def loss_worker(rank: int, world: int) -> dict:
    """For each (mlp_loss, local_loss): the sharded loss of this rank's rows
    through DDP, and the averaged gradients; the local-loss labels'
    offsets; the κ 4-term refusal."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from audio_residual_tpu_torch.training.losses import clip_loss, gather_features

    xa, xt = feature_inputs()
    per = xa.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    res = {}
    for mlp, local in LOSS_CASES:
        model = DistributedDataParallel(FeatureTowers(), find_unused_parameters=True)
        out = model(xa[rows], xt[rows])
        loss = clip_loss(out, group=dist.group.WORLD, mlp_loss=mlp, local_loss=local)
        loss.backward()
        res[(mlp, local)] = {"loss": float(loss.detach()),
                             "grads": {n: torch.zeros_like(p) if p.grad is None
                                       else p.grad.clone()
                                       for n, p in model.module.named_parameters()}}
    # the gathered rows carry gradient back to every shard
    f = xa[rows].clone().requires_grad_(True)
    (all_a, _) = gather_features(f, f, group=dist.group.WORLD)
    (all_a * torch.arange(all_a.shape[0], dtype=all_a.dtype)[:, None]).sum().backward()
    res["gather_grad"] = f.grad.clone()
    try:
        clip_loss(FeatureTowers()(xa[rows], xt[rows]), group=dist.group.WORLD, mlp_loss=True,
                  weight_loss_kappa=1.0)
        res["kappa_raises"] = False
    except NotImplementedError:
        res["kappa_raises"] = True
    return res


def train_worker(rank: int, world: int, steps: int) -> dict:
    """``make_train_step`` over a data-parallel mesh of ``world`` gloo ranks
    on the CLAP fixture's model: each rank's state dict after ``steps``
    steps on its shard of one global batch, and the losses."""
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.parallel.mesh import data_parallel_mesh, shard_batch
    from audio_residual_tpu_torch.training import train_clap as t_tc

    from tests import torch_port_fixture as fx

    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
    opt = t_tc.make_optimizer(model, lr=1e-4, warmup=1, total_steps=10, eps=1e-3,
                              weight_decay=0.1)
    state = t_tc.init_train_state(model, opt)
    mesh = data_parallel_mesh(world, device="cpu")
    step = t_tc.make_train_step(model, opt, mesh=mesh)
    batch = shard_batch(mesh, train_batch())
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "losses": losses}


def train_batch(b: int = 4) -> dict:
    import numpy as np

    from tests import torch_port_fixture as fx

    r = np.random.default_rng(3)
    text = fx.text_inputs("roberta", batch=b, seed=3)
    return {"waveform": (0.1 * r.standard_normal((b, fx.AUDIO_KW["clip_samples"])))
            .astype(np.float32), "input_ids": text["input_ids"],
            "attention_mask": text["attention_mask"]}
