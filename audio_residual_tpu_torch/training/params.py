"""CLI flag system, from ``audio_residual_tpu/training/params.py``: every
flag with the JAX package's default, so every launch script of the reference
and of the JAX package parses.

Reference: `training/params.py:13-567` — one argparse parser shared by the
training/eval CLIs (~80 flags across data / optimization / model /
distributed / precision / checkpointing / eval / linear-probe / augmentation /
reporting groups), with model-dependent lr defaults (`:4-10`) backfilled
post-parse (`:561-566`).

Flags with no effect in the port are kept, accepted and named in a warning
when set, so existing launch scripts parse. ``--fsdp`` parses;
``training/main.py`` refuses it until ``parallel/fsdp.py`` is ported.
"""

from __future__ import annotations

import argparse

__all__ = ["parse_args", "get_default_params"]


def get_default_params(model_name: str) -> dict:
    """Model-dependent optimizer defaults (`params.py:4-10`)."""
    model_name = model_name.lower()
    if "vit" in model_name:
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


def parse_args(args=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("audio-residual-tpu-torch training")

    # data
    p.add_argument("--train-data", type=str, default=None, help="webdataset tar paths / dirs")
    p.add_argument("--val-data", type=str, default=None)
    p.add_argument("--train-num-samples", type=int, default=None)
    p.add_argument("--val-num-samples", type=int, default=None)
    p.add_argument("--dataset-type", choices=["webdataset", "csv", "auto", "toy"], default="auto")
    p.add_argument("--datasetnames", nargs="+", default=None)
    p.add_argument("--datasetinfos", nargs="+", default=None,
                   help="train split names (default train/unbalanced_train/balanced_train)")
    p.add_argument("--full-train-dataset", nargs="+", default=None,
                   help="datasets trained on ALL their splits (dataset_split table)")
    p.add_argument("--exclude-eval-dataset", nargs="+", default=None,
                   help="datasets excluded from the in-training val split")
    p.add_argument("--dataset-proportion", type=float, default=1.0)
    p.add_argument("--datasetpath", type=str, default=None)
    p.add_argument("--remotedata", action="store_true", default=False,
                   help="accepted for compat; this build reads local shards only")
    p.add_argument("--class-label-path", type=str, default=None,
                   help="class-index pickle/json -> args.class_index_dict (data.py:853)")
    p.add_argument("--workers", type=int, default=1,
                   help="accepted for compat; batches come from the training process "
                        "(see --prefetch-factor)")
    p.add_argument("--prefetch-factor", type=int, default=None,
                   help="background-thread batch prefetch depth "
                        "(utils/misc.prefetch_batches; torch DataLoader's "
                        "knob, reference params.py:553-557)")
    p.add_argument("--train-ipc", type=str, default=None,
                   help="npy of per-class sample indices for the toy "
                        "balanced queue (`data.py:815`); None derives it "
                        "from the h5 targets")
    p.add_argument("--val-ipc", type=str, default=None)
    # open_clip csv legacy: parsed like the reference, whose own dispatcher
    # raises 'Unsupported dataset type: csv' (`data.py:846`) — no csv path
    # shipped there or here
    p.add_argument("--csv-separator", type=str, default="\t")
    p.add_argument("--csv-img-key", type=str, default="filepath")
    p.add_argument("--csv-caption-key", type=str, default="title")

    # model
    p.add_argument("--amodel", type=str, default="HTSAT-tiny")
    p.add_argument("--tmodel", type=str, default="roberta",
                   choices=["transformer", "bert", "roberta", "bart"])
    p.add_argument("--pretrained", type=str, default="")
    p.add_argument("--pretrained-audio", type=str, default="")
    p.add_argument("--pretrained-text", type=str, default="")
    p.add_argument("--freeze-text", action="store_true", default=False)
    p.add_argument("--freeze-text-after", type=int, default=-1)
    p.add_argument("--enable-fusion", action="store_true", default=False)
    p.add_argument("--fusion-type", type=str, default="None",
                   choices=["None", "daf_1d", "aff_1d", "iaff_1d", "daf_2d", "aff_2d", "iaff_2d", "channel_map"])
    p.add_argument("--force-quick-gelu", action="store_true", default=False,
                   help="QuickGELU in the CLIP transformer towers "
                        "(reference factory.py:129-131)")
    # open_clip vision legacy (warned below; functional equivalents noted)
    p.add_argument("--pretrained-image", action="store_true", default=False)
    p.add_argument("--lock-image", action="store_true", default=False)
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    p.add_argument("--lock-image-freeze-bn-stats", action="store_true", default=False)
    # torch-jit legacy: the port's forward is eager PyTorch and its kernels
    p.add_argument("--torchscript", action="store_true", default=False)
    p.add_argument("--trace", action="store_true", default=False)
    p.add_argument("--openai-model-cache-dir", type=str, default="~/.cache/clip",
                   help="download cache for pretrained=openai CLIP weights")

    # optimization
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=32)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--warmup", type=int, default=10000)
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adamw", "sgd", "adam"])
    p.add_argument("--skip-scheduler", action="store_true", default=False,
                   help="hold lr at the base value (no warmup/cosine decay); "
                        "the reference parses this and never wires it "
                        "(params.py:233-237) — here it works")
    p.add_argument("--sleep", type=float, default=0,
                   help="sleep n seconds before start (`lp_main.py:296`)")
    p.add_argument("--split-opt", action="store_true", default=False,
                   help="separate optimizer groups for pretrained vs new params")
    for pg in ("pretrained", "new"):
        p.add_argument(f"--lr-{pg}", type=float, default=None)
        p.add_argument(f"--beta1-{pg}", type=float, default=None)
        p.add_argument(f"--beta2-{pg}", type=float, default=None)
        p.add_argument(f"--eps-{pg}", type=float, default=None)
        p.add_argument(f"--wd-{pg}", type=float, default=0.2)
        p.add_argument(f"--momentum-{pg}", type=float, default=0.9)

    # loss
    p.add_argument("--mlp-loss", action="store_true", default=False, help="4-term loss")
    p.add_argument("--local-loss", action="store_true", default=False)
    p.add_argument("--gather-with-grad", action="store_true", default=True,
                   help="always true: the loss gathers with torch.distributed.nn's "
                        "differentiable all_gather")
    p.add_argument("--kappa", type=float, default=0.0, help="weighted-loss kappa")
    p.add_argument("--clap-mlploss", action="store_true", default=False)

    # augmentation
    p.add_argument("--mixup", action="store_true", default=False)
    p.add_argument("--text-augment-selection", type=str, default=None)
    p.add_argument("--data-filling", type=str, default="pad",
                   choices=["repeatpad", "pad", "repeat"])
    p.add_argument("--data-truncating", type=str, default="rand_trunc",
                   choices=["rand_trunc", "fusion"])

    # checkpointing / logging
    p.add_argument("--logs", type=str, default="./logs/")
    p.add_argument("--log-local", action="store_true", default=False)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--save-top-performance", type=int, default=0)
    p.add_argument("--save-most-recent", action="store_true", default=False)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--copy-codebase", action="store_true", default=False)

    # eval
    p.add_argument("--val-frequency", type=int, default=1)
    # parsed like the reference, which itself never consumes it: the
    # zero_shot_eval call is commented out in evaluate (train.py:274-276)
    p.add_argument("--zeroshot-frequency", type=int, default=2)
    p.add_argument("--parallel-eval", action="store_true", default=False,
                   help="accepted for compat: validation runs on the master "
                        "rank over the whole val set")
    p.add_argument("--no-eval", action="store_true", default=False)
    # CLIP-legacy imagenet zero-shot paths: the consuming evaluator is dead
    # code in the reference ("not supported for CLAP", zero_shot.py:13-91);
    # the batched equivalent lives in evaluate/zero_shot_imagenet.py
    p.add_argument("--imagenet-val", type=str, default=None)
    p.add_argument("--imagenet-v2", type=str, default=None)
    p.add_argument("--top-k-checkpoint-select-dataset", type=str, default="all")
    p.add_argument("--top-k-checkpoint-select-metric", type=str, default="_R@10")

    # precision: bf16 operands with f32 accumulate and f32 params; no grad
    # scaler (bf16 needs none)
    p.add_argument("--precision", type=str, default="amp",
                   choices=["amp", "fp16", "fp32", "bf16"],
                   help="amp/bf16/fp16 -> the bf16 AMP route; fp32 -> golden f32")
    # the JAX package's addition (no reference equivalent): the dual-tower
    # forward under torch.utils.checkpoint -- the backward recomputes the
    # activations, trading FLOPs for memory. Gradients are exact.
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialise tower activations in backward")
    # the JAX package's FSDP/ZeRO-3 state sharding (parallel/fsdp.py): parsed,
    # refused by training/main.py until it is ported
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="shard params/grads/optimizer state over the mesh (not ported)")

    # distributed: one process a card; the rendezvous comes from the
    # launcher's environment (parallel/distributed.py)
    p.add_argument("--dist-url", type=str, default="env://")
    p.add_argument("--dist-backend", type=str, default="nccl",
                   help="torch.distributed backend on the card (gloo on the CPU)")
    p.add_argument("--horovod", action="store_true", default=False, help="not supported")
    p.add_argument("--ddp-static-graph", action="store_true", default=False, help="ignored")
    p.add_argument("--no-set-device-rank", action="store_true", default=False)
    p.add_argument("--use-bn-sync", action="store_true", default=False,
                   help="bn0's statistics are always those of the whole batch of every rank")

    # linear probe
    p.add_argument("--lp-mlp", action="store_true", default=False)
    p.add_argument("--lp-freeze", action="store_true", default=False)
    p.add_argument("--lp-act", type=str, default="None")
    p.add_argument("--lp-loss", type=str, default="bce", choices=["bce", "ce", "mse"])
    p.add_argument("--lp-metrics", type=str, default="map,mauc,acc")
    p.add_argument("--lp-lr", type=float, default=1e-4)

    # reporting
    p.add_argument("--report-to", type=str, default="")
    p.add_argument("--wandb-notes", type=str, default="")
    p.add_argument("--wandb-id", type=str, default=None)
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=4242)

    ns = p.parse_args(args)

    # torch-only flags are accepted for script compatibility but must not
    # pass silently — say exactly what each maps to here
    import logging

    if ns.horovod:
        logging.warning(
            "--horovod has no effect: the port runs torch.distributed with one "
            "process a card (the reference's Horovod path, distributed.py:70-88, "
            "is not carried over)"
        )
    if ns.parallel_eval:
        logging.warning(
            "--parallel-eval has no effect: validation runs on the master rank "
            "over the whole val set"
        )
    if ns.ddp_static_graph:
        logging.warning("--ddp-static-graph has no effect: DDP finds the unused "
                        "parameters of each step")
    if ns.local_loss:
        logging.warning(
            "--local-loss: the train step uses the global-batch formulation, "
            "which gives the same gradients (losses.clip_loss); the local-loss "
            "variant with rank-offset labels exists for explicit use and is "
            "tested equal (tests/test_torch_losses.py)"
        )
    if ns.remotedata:
        logging.warning(
            "--remotedata: this build reads local shards only (no S3 "
            "fetch); point --datasetpath at the local mirror"
        )
    if ns.torchscript or ns.trace:
        logging.warning(
            "--torchscript/--trace have no effect: the port runs its forward "
            "eagerly (the reference's torch.jit.trace_module path, "
            "model.py:896-912)"
        )
    if ns.lock_image or ns.lock_image_unlocked_groups or ns.lock_image_freeze_bn_stats:
        logging.warning(
            "--lock-image* has no effect: the vision towers are not ported "
            "(the reference's lock() path is vision-legacy its CLAP never builds)"
        )
    if ns.pretrained_image:
        logging.warning(
            "--pretrained-image has no effect: the vision towers are not ported"
        )
    if ns.imagenet_val or ns.imagenet_v2:
        logging.warning(
            "--imagenet-val/--imagenet-v2 have no effect: the consuming "
            "evaluator is dead code in the reference (zero_shot.py 'not "
            "supported for CLAP')"
        )

    # model-dependent defaults backfill (`params.py:561-566`)
    defaults = get_default_params(ns.amodel)
    for k, v in defaults.items():
        if getattr(ns, k) is None:
            setattr(ns, k, v)
    return ns
