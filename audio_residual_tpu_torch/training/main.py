"""Contrastive training CLI: ``python -m audio_residual_tpu_torch.training.main``.

Port of ``audio_residual_tpu/training/main.py`` (the reference's
`training/main.py:125-596`): experiment naming, log and checkpoint dirs,
``params.txt``, the rendezvous, the model, the optimizer groups, the cosine
schedule, ``--resume``, the epoch loop (:func:`train_one_epoch`) with
validation and the top-K checkpoint rotation.

Differences by design: one process a card (``torchrun``, SLURM or MPI name
the world, :mod:`..parallel.distributed`) with ``DistributedDataParallel``
where the JAX package drives its whole mesh from one process; the
randomness of epoch ``e`` comes from a generator seeded from ``(seed, e)``,
so a resume at an epoch boundary replays the epochs it skips exactly; a toy
set without ``--train-data`` is written in the run's log directory.
``--dataset-type auto`` (the default) and ``webdataset`` read local tar
shards through ``data/shards.py`` (:func:`build_data`), the JAX package's
batches bit for bit. ``--fsdp`` shards the parameters and the optimizer
state over the ranks (``parallel/fsdp.py``), a world of one process too,
before the optimizer is built; its checkpoints are the unsharded files a run
without it writes, and its validation runs on every rank, since a sharded
forward is a collective.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from datetime import datetime

import numpy as np
import torch

from audio_residual_tpu_torch.data.shards import ShardedAudioText, resolve_tar_paths, sample_prop
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.parallel.distributed import init_distributed
from audio_residual_tpu_torch.parallel.fsdp import fsdp_mesh, shard_model
from audio_residual_tpu_torch.parallel.mesh import data_parallel_mesh, shard_batch
from audio_residual_tpu_torch.training import checkpoints
from audio_residual_tpu_torch.training.logger import AverageMeter, MetricLogger, setup_logging
from audio_residual_tpu_torch.training.params import parse_args
from audio_residual_tpu_torch.training.train_clap import (init_train_state, make_optimizer,
                                                          make_split_optimizer,
                                                          make_train_step)
from audio_residual_tpu_torch.utils.misc import dataset_split, load_class_label, prefetch_batches
from audio_residual_tpu_torch.utils.tokenizer import load_default_tokenizer

__all__ = ["main", "train_one_epoch", "epoch_generator", "build_data", "BATCH_KEYS"]

BATCH_KEYS = ("waveform", "input_ids", "attention_mask")


def copy_codebase(log_base: str) -> None:
    """Snapshot the package into the run dir (`main.py:576-593`)."""
    import audio_residual_tpu_torch

    src = os.path.dirname(audio_residual_tpu_torch.__file__)
    dst = os.path.join(log_base, "code", "audio_residual_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))


def _experiment_name(args) -> str:
    if args.name:
        return args.name
    return "-".join([datetime.now().strftime("%Y_%m_%d-%H_%M_%S"), f"model_{args.amodel}",
                     f"lr_{args.lr}", f"b_{args.batch_size}"])


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The CPU generator of epoch ``epoch``'s draws: each step takes one seed
    from it for the towers' generator on the card."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0] >> 1))


def _toy_batches_fn(path, args, audio_cfg, tokenize, *, is_train=True):
    from audio_residual_tpu_torch.data.toy import ToyDataset, make_toy_h5

    if not os.path.exists(path):
        make_toy_h5(path, clip_samples=audio_cfg["clip_samples"])
    ipc = args.train_ipc if is_train else args.val_ipc
    ds = ToyDataset(path, ipc_path=ipc, eval_mode=not is_train)

    def epochs(epoch=0):
        for b in ds.batches(args.batch_size):
            enc = tokenize(b["text"])
            yield {"waveform": b["waveform"], "input_ids": np.asarray(enc["input_ids"]),
                   "attention_mask": np.asarray(enc["attention_mask"])}

    return epochs


def _resolve_split_tars(root, names, splits, *, full_dataset=None):
    """Shard discovery over several split names (the reference's
    ``get_tar_path_from_dataset_name``, `clap_module/utils.py:113-151`): a
    missing split is skipped; a name in ``full_dataset`` trains on all of
    its splits (``utils/misc.py::dataset_split``)."""
    paths, sizes = [], {}
    for n in names:
        name_splits = dataset_split.get(n, splits) if full_dataset and n in full_dataset else splits
        for s in name_splits:
            pp, ss = resolve_tar_paths(root, [n], s)
            paths += pp
            sizes.update(ss)
    return paths, sizes


def build_data(args, model_cfg, tokenize, log_base: str, device=None):
    """``get_data`` (`data.py:850-900`) -> ``(train_epochs_fn,
    total_train_samples, val_batches_fn | None)``. ``auto`` and
    ``webdataset``: the tar shards under ``--datasetpath`` (or
    ``--train-data``), train splits from ``--datasetinfos``, val from the
    valid/test/eval splits of the names not excluded, the val pipe fixed at
    epoch 0; a fusion mel runs on ``device``."""
    audio_cfg = model_cfg["audio_cfg"]
    args.class_index_dict = load_class_label(args.class_label_path)
    if args.dataset_type == "toy":
        epochs = _toy_batches_fn(args.train_data or os.path.join(log_base, "toy_train.h5"),
                                 args, audio_cfg, tokenize)
        val_fn = None
        if args.val_data:
            val_fn = _toy_batches_fn(args.val_data, args, audio_cfg, tokenize, is_train=False)
        return epochs, None, val_fn
    if args.dataset_type == "csv":
        # the reference's own dispatcher raises this (`data.py:846`)
        raise ValueError(f"Unsupported dataset type: {args.dataset_type}")
    names = args.datasetnames or ["audioset"]
    infos = args.datasetinfos or ["train", "unbalanced_train", "balanced_train"]
    root = args.datasetpath or args.train_data
    paths, sizes = _resolve_split_tars(root, names, infos, full_dataset=args.full_train_dataset)
    paths, total = sample_prop(paths, sizes, args.dataset_proportion)

    def pipe(tar_paths, num_samples):
        return ShardedAudioText(
            tar_paths=tar_paths, tokenize=tokenize, batch_size=args.batch_size,
            max_len=audio_cfg["clip_samples"], data_truncating=args.data_truncating,
            data_filling=args.data_filling, audio_cfg=audio_cfg,
            batches_per_epoch=num_samples // args.batch_size if num_samples else None,
            text_augment_selection=args.text_augment_selection, device=device)

    pipeline = pipe(paths, args.train_num_samples)
    val_fn = None
    excluded = (args.full_train_dataset or []) + (args.exclude_eval_dataset or [])
    val_names = [n for n in names if n not in excluded] if excluded else names
    args.val_dataset_names = val_names
    val_paths, _ = _resolve_split_tars(args.val_data or root, val_names,
                                       ["valid", "test", "eval"])
    if val_paths:
        val_pipe = pipe(val_paths, args.val_num_samples)
        val_fn = lambda: val_pipe.epoch(0)  # noqa: E731  (fixed order and crops)
    return pipeline.epoch, total, val_fn


def train_one_epoch(state: dict, step_fn, batches, *, epoch: int, mesh,
                    generator: torch.Generator | None, metric_logger=None,
                    log_every: int = 100, prefetch_factor: int | None = None) -> dict:
    """One epoch of ``step_fn`` over the global batches ``batches`` (dicts of
    arrays or tensors), each sharded to this rank's rows on its card.
    Returns ``{"steps", "loss", "metrics"}``: the steps taken, the last
    loss, the last step's metrics."""
    batch_time, data_time = AverageMeter(), AverageMeter()
    metrics, steps = {}, 0
    end = time.time()
    for batch in prefetch_batches(batches, prefetch_factor):
        data_time.update(time.time() - end)
        device_batch = shard_batch(mesh, {k: v for k, v in batch.items() if k in BATCH_KEYS})
        state, metrics = step_fn(state, device_batch, generator)
        steps += 1
        batch_time.update(time.time() - end)
        end = time.time()
        if state["step"] % log_every == 0:
            loss, scale = float(metrics["loss"]), float(metrics["logit_scale_a"])
            logging.info("epoch %d step %d loss %.4f scale %.2f batch %.3fs data %.3fs", epoch,
                         state["step"], loss, scale, batch_time.avg, data_time.avg)
            if metric_logger is not None:
                metric_logger.log({"loss": loss, "logit_scale_a": scale, "epoch": epoch},
                                  step=state["step"])
    return {"steps": steps, "loss": float(metrics["loss"]) if metrics else None,
            "metrics": metrics}


@torch.no_grad()
def _run_validation(model, val_fn, args, mesh, compute_dtype, epoch, metric_logger) -> dict:
    """In-training validation (`train.py:266-501`, the generic-val branch):
    embed the whole val set, then ``clap_val_metrics`` over the full
    similarity matrix and a ``results.jsonl`` record (the ``all`` group;
    none without ``metric_logger``). Under ``--fsdp`` every rank runs it and
    takes rank 0's metrics, so that every rank makes the same checkpoint
    decisions."""
    from audio_residual_tpu_torch.evaluate.metrics import clap_val_metrics

    keys = ("audio_features", "text_features", "audio_features_mlp", "text_features_mlp")
    feats = {k: [] for k in keys}
    scale_a = scale_t = 1.0
    n = 0
    for i, batch in enumerate(val_fn()):
        b = {k: torch.as_tensor(v).to(mesh.device) for k, v in batch.items() if k in BATCH_KEYS}
        out = model({"waveform": b["waveform"]}, b["input_ids"], b.get("attention_mask"),
                    compute_dtype=compute_dtype)
        for k in keys:
            feats[k].append(out[k].float().cpu().numpy())
        scale_a, scale_t = float(out["logit_scale_a"]), float(out["logit_scale_t"])
        n += int(b["waveform"].shape[0])
        if i % 100 == 0:
            logging.info("Eval Epoch: %d [%d samples]", epoch, n)
    if n == 0:
        return {}
    cat = {k: np.concatenate(v) for k, v in feats.items()}
    m = clap_val_metrics(cat["audio_features"], cat["text_features"], scale_a,
                         cat["audio_features_mlp"], cat["text_features_mlp"], scale_t,
                         mlp_loss=args.clap_mlploss or args.mlp_loss)
    metrics = {f"all/{k}": v for k, v in m.items()}
    metrics["epoch"] = epoch
    if args.fsdp and mesh.world_size > 1:
        shared = [metrics]
        torch.distributed.broadcast_object_list(shared, src=0, group=mesh.group)
        metrics = shared[0]
    logging.info("Eval Epoch: %d %s", epoch, "\t".join(
        f"{k}: {v:.4f}" for k, v in metrics.items() if isinstance(v, float)))
    if metric_logger is not None:
        metric_logger.log({f"val/{k}": v for k, v in metrics.items()}, step=epoch)
    return metrics


def _optimizer(args, model, total_steps: int):
    if args.optimizer == "adam":
        # the reference zeroes every decay under plain adam (`main.py:312-314`)
        args.wd = args.wd_pretrained = args.wd_new = 0.0
    if args.split_opt:
        # per-group hyperparameters fall back to the shared ones (`main.py:323-326`)
        for x in ("lr", "beta1", "beta2", "eps"):
            for y in ("_new", "_pretrained"):
                if getattr(args, x + y) is None:
                    setattr(args, x + y, getattr(args, x))
        return make_split_optimizer(
            model, lr_pretrained=args.lr_pretrained, lr_new=args.lr_new,
            weight_decay_pretrained=args.wd_pretrained, weight_decay_new=args.wd_new,
            warmup=args.warmup, total_steps=total_steps,
            betas_pretrained=(args.beta1_pretrained, args.beta2_pretrained),
            betas_new=(args.beta1_new, args.beta2_new), eps_pretrained=args.eps_pretrained,
            eps_new=args.eps_new, name=args.optimizer,
            momentum_pretrained=args.momentum_pretrained, momentum_new=args.momentum_new,
            skip_scheduler=args.skip_scheduler)
    return make_optimizer(model, lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
                          weight_decay=args.wd, warmup=args.warmup, total_steps=total_steps,
                          name=args.optimizer, momentum=args.momentum,
                          skip_scheduler=args.skip_scheduler)


def main(argv=None, *, device: str | None = None, tokenizer=None) -> dict:
    """The CLI. ``device``: None is the card of this process's local rank;
    ``"cpu"`` runs the plain versions on the CPU over gloo. ``tokenizer``
    replaces ``load_default_tokenizer``. Under ``--fsdp`` in a world of one
    process, the group it shards over is destroyed on return: the returned
    state is for reading, not for further steps."""
    args = parse_args(argv)
    np.random.seed(args.seed)
    world = init_distributed(device=device)
    dev = world["device"]
    master = world["rank"] == 0

    name = _experiment_name(args)
    log_base = os.path.join(args.logs, name)
    ckpt_dir = os.path.join(log_base, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    setup_logging(os.path.join(log_base, "out.log") if master else None,
                  level=logging.DEBUG if args.debug else logging.INFO,
                  include_host=not args.log_local)
    if master:
        with open(os.path.join(log_base, "params.txt"), "w") as f:  # `main.py:260-265`
            for k in sorted(vars(args)):
                f.write(f"{k}: {getattr(args, k)}\n")
        if args.copy_codebase:
            copy_codebase(log_base)
    if args.sleep:
        time.sleep(args.sleep)  # `lp_main.py:296`

    model, cfg, model_cfg = factory.create_model(
        args.amodel, args.tmodel, args.pretrained, enable_fusion=args.enable_fusion,
        seed=args.seed, device=dev, pretrained_audio=args.pretrained_audio,
        pretrained_text=args.pretrained_text, force_quick_gelu=args.force_quick_gelu)
    tokenize = tokenizer or load_default_tokenizer(cfg.context_length)
    epochs_fn, total_samples, val_fn = build_data(args, model_cfg, tokenize, log_base, dev)

    steps_per_epoch = (total_samples or (args.train_num_samples or 1024)) // args.batch_size
    total_steps = max(steps_per_epoch * args.epochs, 1)
    # a world of one process shards over a group of its own, destroyed on return
    own_group = args.fsdp and not torch.distributed.is_initialized()
    try:
        if args.fsdp:
            # before the optimizer, so that Adam's moments lie on the shards
            mesh = shard_mesh = fsdp_mesh(dev)
            shard_model(model, mesh)
        else:
            mesh, shard_mesh = data_parallel_mesh(device=dev), None
        state = init_train_state(model, _optimizer(args, model, total_steps))
        compute_dtype = torch.bfloat16 if args.precision in ("amp", "bf16", "fp16") else None

        def step_fn_for(freeze_text: bool):
            return make_train_step(model, state["optimizer"],
                                   mlp_loss=args.clap_mlploss or args.mlp_loss,
                                   compute_dtype=compute_dtype, freeze_text=freeze_text,
                                   remat=args.remat, weight_loss_kappa=args.kappa,
                                   mesh=None if args.fsdp else mesh, fsdp_mesh=shard_mesh)

        step_fn = step_fn_for(args.freeze_text)
        start_epoch = 0
        if args.resume:
            checkpoints.load_checkpoint(args.resume, state)
            start_epoch = state["step"] // max(steps_per_epoch, 1)
            logging.info("resumed from %s at epoch %d", args.resume, start_epoch)

        metric_logger = MetricLogger(
            log_base, tuple(filter(None, args.report_to.split(","))) if master else (),
            wandb_kwargs={"project": "clap", "name": name, "notes": args.wandb_notes,
                          "id": args.wandb_id, "resume": "allow" if args.wandb_id else None})
        top_k = ({i: -np.inf for i in range(args.save_top_performance)}
                 if args.save_top_performance else {})
        last_metrics: dict = {}

        def validate(epoch):
            return _run_validation(model, val_fn, args, mesh, compute_dtype, epoch,
                                   metric_logger if master else None)

        # a sharded model's forward and state dict are collectives: every rank
        # validates and gathers the checkpoints, rank 0 writes
        evaluates = master or args.fsdp
        if val_fn is not None and not args.no_eval and start_epoch == 0 and evaluates:
            last_metrics = validate(0)  # eval before training (`main.py:497-501`)
        for epoch in range(start_epoch, args.epochs):
            if (args.freeze_text_after >= 0 and epoch == args.freeze_text_after
                    and not args.freeze_text):
                logging.info("Text parameters frozen from epoch %d", epoch)  # `main.py:510-513`
                args.freeze_text = True
                step_fn = step_fn_for(True)
            train_one_epoch(state, step_fn, epochs_fn(epoch), epoch=epoch, mesh=mesh,
                            generator=epoch_generator(args.seed, epoch),
                            metric_logger=metric_logger if master else None,
                            prefetch_factor=args.prefetch_factor)
            completed = epoch + 1
            if not evaluates:
                continue
            if (val_fn is not None and not args.no_eval and args.val_frequency
                    and (completed % args.val_frequency == 0 or completed == args.epochs)):
                last_metrics = validate(completed)
                if args.save_top_performance and last_metrics:
                    # the mean of the metrics of the select metric and dataset
                    # (`main.py:526-534`)
                    picked = [v for k, v in last_metrics.items()
                              if args.top_k_checkpoint_select_metric in k
                              and args.top_k_checkpoint_select_dataset in k]
                    if picked:
                        top_k = checkpoints.update_top_k_performance(
                            float(np.mean(picked)), top_k, ckpt_dir, state, epoch=epoch, name=name)
            if completed % args.save_frequency == 0:
                checkpoints.save_checkpoint(ckpt_dir, state, epoch, name)
            if args.save_most_recent:
                checkpoints.save_most_recent(ckpt_dir, state, epoch, name)

        return {"state": state, "ckpt_dir": ckpt_dir, "steps": state["step"],
                "metrics": last_metrics, "top_k": top_k, "log_dir": log_base}
    finally:
        if own_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
