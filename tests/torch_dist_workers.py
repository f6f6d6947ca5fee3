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


def fsdp_worker(rank: int, world: int, steps: int) -> dict:
    """``make_train_step`` over FSDP (``parallel/fsdp.py``) on ``world`` gloo
    ranks on the CLAP fixture's model, each rank its shard of one global
    batch: the losses and gradient norms; the unsharded model and optimizer
    state dicts after ``steps`` steps (rank 0; empty on the others); each
    sharded parameter's
    placements and local shape and its Adam moments'; every replicated
    parameter."""
    from torch.distributed.tensor import DTensor

    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.parallel import fsdp
    from audio_residual_tpu_torch.parallel.mesh import shard_batch
    from audio_residual_tpu_torch.training import train_clap as t_tc

    from tests import torch_port_fixture as fx

    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
    mesh = fsdp.fsdp_mesh("cpu")
    fsdp.shard_model(model, mesh)
    opt = t_tc.make_optimizer(model, lr=1e-4, warmup=1, total_steps=10, eps=1e-3,
                              weight_decay=0.1)
    state = t_tc.init_train_state(model, opt)
    step = t_tc.make_train_step(model, opt, fsdp_mesh=mesh)
    batch = shard_batch(mesh, train_batch())
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))

    def where(t):
        return [str(p) for p in t.placements], tuple(t.to_local().shape)

    shards = {n: {"param": where(p), "moments": [where(opt.state[p][k])
                                                 for k in ("exp_avg", "exp_avg_sq")]}
              for n, p in model.named_parameters() if isinstance(p, DTensor)}
    replicated = {n: p.detach().clone() for n, p in model.named_parameters()
                  if not isinstance(p, DTensor)}
    sd, optim_sd = fsdp.full_state_dict(model, opt)
    return {"losses": losses, "grad_norms": norms, "state_dict": sd, "optimizer": optim_sd,
            "shards": shards, "replicated": replicated}


def narrow_create_model(*a, device=None, seed=0, **k):
    """``factory.create_model`` of the CLI tests: the CLAP fixture's narrow
    roberta model, HTSAT-tiny's config at the fixture's clip length."""
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.models import factory as t_factory

    from tests import torch_port_fixture as fx

    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=seed, device=device)
    model_cfg = t_factory.get_model_config("HTSAT-tiny")
    return model, fx.port_clap_config("roberta"), {
        **model_cfg, "audio_cfg": {**model_cfg["audio_cfg"],
                                   "clip_samples": fx.AUDIO_KW["clip_samples"]}}


def fsdp_main_worker(rank: int, world: int, argv: list, resume_argv: list) -> dict:
    """``training/main.py`` with ``--fsdp`` on ``world`` gloo ranks
    (``factory.create_model`` swapped for :func:`narrow_create_model`): a
    run from ``argv``, then a resumed one from ``resume_argv``; each one's
    step count and checkpoint directory."""
    import unittest.mock as mock

    from audio_residual_tpu_torch.models import factory as t_factory
    from audio_residual_tpu_torch.training import main as t_main
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    from tests import torch_port_fixture as fx

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    tok = HashTokenizer(vocab_size=1000, context_length=fx.CLAP_CONTEXT)
    out = {}
    with mock.patch.object(t_factory, "create_model", narrow_create_model):
        for key, args in (("run", argv), ("resumed", resume_argv)):
            res = t_main.main(args, device="cpu", tokenizer=tok)
            out[key] = {"steps": res["steps"], "ckpt_dir": res["ckpt_dir"]}
    return out


def assert_moments_close(got: dict, want: dict) -> None:
    """Two optimizer states, ``{key: {moment: tensor}}`` with the same keys:
    each moment within rtol 1e-4 and an atol of 1e-4 of its own largest
    magnitude, or of a millionth of the largest of its kind over all keys
    where that is more (a gradient zero in exact arithmetic, such as an
    attention key bias's, leaves a moment of rounding noise alone). A
    moment on another parameter is off by its whole scale."""
    import numpy as np

    assert got.keys() == want.keys()
    kinds = {k for m in want.values() for k in m if k != "step"}
    top = {k: max(float(m[k].abs().max()) for m in want.values() if k in m) for k in kinds}
    for key, moments in want.items():
        assert got[key].keys() == moments.keys(), key
        for k, v in moments.items():
            assert got[key][k].shape == v.shape, (key, k)
            floor = 1e-6 * top[k] if k in top else 0.0
            np.testing.assert_allclose(got[key][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-4 * max(float(v.abs().max()), floor),
                                       err_msg=f"{key} {k}")
