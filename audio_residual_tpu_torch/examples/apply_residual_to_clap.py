"""Experiment driver 2: compute ResiDual PCA bases and train λ.

Port of ``examples/2_apply_residual_to_clap.py``, the script form of
`2_Apply_ResiDual_to_CLAP.ipynb`: per (layer, fold), stream the train fold
through the encoder collecting residual-stream taps, fit PCA on the card,
pickle the basis (reference format), then run the zero-shot λ-training once
or over the reference sweep grid (`src/training.py:72-140`).

Run: ``python -m audio_residual_tpu_torch.examples.apply_residual_to_clap --ckpt ... --layers 0``
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import torch

from audio_residual_tpu_torch.data.datasets import class_prompts, get_fold_loaders
from audio_residual_tpu_torch.data.featurize import featurize_batch
from audio_residual_tpu_torch.models.clap import encode_audio
from audio_residual_tpu_torch.module import CLAPModule
from audio_residual_tpu_torch.residual.analyze import compute_pca_components
from audio_residual_tpu_torch.training.train_residual import train_with_config

# the reference's W&B sweep grid (notebook 2 cell 15)
SWEEP_GRID = {
    "lr": [1e-3, 3e-3, 1e-2],
    "epochs": [10, 30, 50],
    "inject_layers": [(3,), (0,), (2, 3), (0, 1), (0, 1, 2, 3)],
}


def main(argv=None, *, device=None) -> dict:
    """Returns ``{"pca": [paths written], "runs": [{"config", "best_val_acc"}],
    "best": (config, best_val_acc)}``, what it prints."""
    from audio_residual_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--dataset", default="ESC50")
    p.add_argument("--root", default=".")
    p.add_argument("--layers", type=int, nargs="+", default=[0])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--pca-path", default="residual_pca")
    p.add_argument("--sweep", action="store_true", help="run the full hyperparameter grid")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=10)
    args = p.parse_args(argv)

    module = CLAPModule(device=device)
    if args.ckpt:
        module.load_ckpt(args.ckpt)
    cfg = module.cfg
    folds = get_fold_loaders(args.dataset, args.root, args.batch_size)
    text_embeds = torch.as_tensor(module.get_text_embedding(class_prompts(args.dataset)),
                                  device=module.device)

    def encode_with_taps(wav):
        batch = featurize_batch(wav, cfg.audio.clip_samples)
        return encode_audio(module.model, batch, taps=("residual",))

    # 1) PCA bases per (layer, fold) — reference pickle format
    written = []
    for fold, (train_batches, _) in enumerate(folds):
        for layer in args.layers:
            path = os.path.join(args.pca_path, args.dataset, f"layer_{layer}_evalfold_{fold}")
            if os.path.exists(path):
                continue
            compute_pca_components(
                encode_with_taps,
                (wav for wav, _ in train_batches()),
                layer, cfg.audio.layer_dim(layer),
                max_batches=args.max_batches, save_path=path, device=module.device,
            )
            written.append(path)
            print("pca saved:", path)

    # 2) λ training — single config or the reference sweep grid
    configs = (
        [dict(lr=lr, epochs=e, inject_layers=il, eval_fold=f)
         for lr, e, il, f in itertools.product(
             SWEEP_GRID["lr"], SWEEP_GRID["epochs"], SWEEP_GRID["inject_layers"],
             range(len(folds)))]
        if args.sweep
        else [dict(lr=args.lr, epochs=args.epochs, inject_layers=tuple(args.layers), eval_fold=0)]
    )
    best, runs = None, []
    for config in configs:
        res = train_with_config(
            config, module.model, args.dataset, folds, text_embeds, args.pca_path,
            log_fn=lambda r: print({k: v for k, v in r.items() if k != "lambda_hist"}),
        )
        run = {"config": {k: list(v) if isinstance(v, tuple) else v for k, v in config.items()},
               "best_val_acc": res["best_val_acc"]}
        runs.append(run)
        print(json.dumps(run))
        if best is None or res["best_val_acc"] > best[1]:
            best = (config, res["best_val_acc"])
    print("BEST:", best)
    return {"pca": written, "runs": runs, "best": best}


if __name__ == "__main__":
    main()
