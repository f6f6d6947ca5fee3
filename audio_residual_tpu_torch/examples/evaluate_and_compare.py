"""Experiment driver 3: evaluate and compare the three CLAP variants.

Port of ``examples/3_evaluate_and_compare.py``, the script form of
`3_Evaluate_and_compare_CLAP_performance.ipynb`: K-fold evaluation of (a)
the pretrained zero-shot baseline, (b) the ResiDual-injected model (its PCA
bases from :mod:`.apply_residual_to_clap`), (c) the frozen-encoder linear
probe; aggregate metrics (mean±std accuracy, macro P/R/F1, summed confusion
matrix) in the PDF Table-1 layout, written to ``{save_dir}/{dataset}_table.json``.

Run: ``python -m audio_residual_tpu_torch.examples.evaluate_and_compare --ckpt ... --save-dir eval``
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from audio_residual_tpu_torch.data.datasets import DATASETS, class_prompts, get_fold_loaders
from audio_residual_tpu_torch.evaluate.harness import compare_variants
from audio_residual_tpu_torch.module import CLAPModule
from audio_residual_tpu_torch.training.linear_probe import train_and_eval_linear_head
from audio_residual_tpu_torch.training.train_residual import (
    evaluate_baseline_clap,
    train_and_evaluate_residual,
)


def main(argv=None, *, device=None) -> dict:
    """Returns ``{variant: fold accuracies}`` and ``"table"``, the
    ``compare_variants`` table, what it prints."""
    from audio_residual_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None)
    p.add_argument("--dataset", default="ESC50")
    p.add_argument("--root", default=".")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pca-path", default="residual_pca")
    p.add_argument("--save-dir", default="eval")
    p.add_argument("--inject-layers", type=int, nargs="+", default=[0])
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--skip", nargs="*", default=[], choices=["baseline", "residual", "linear"])
    args = p.parse_args(argv)

    module = CLAPModule(device=device)
    if args.ckpt:
        module.load_ckpt(args.ckpt)
    folds = get_fold_loaders(args.dataset, args.root, args.batch_size)
    text_embeds = torch.as_tensor(module.get_text_embedding(class_prompts(args.dataset)),
                                  device=module.device)
    n_classes = len(DATASETS[args.dataset]["class_labels"])

    out = {}
    if "baseline" not in args.skip:
        r = evaluate_baseline_clap(module.model, args.dataset, folds, text_embeds, args.save_dir)
        out["baseline"] = [f["accuracy"] for f in r]
        print("baseline:", out["baseline"])
    if "residual" not in args.skip:
        r = train_and_evaluate_residual(
            module.model, args.dataset, folds, text_embeds,
            args.pca_path, args.save_dir, epochs=args.epochs, lr=args.lr,
            inject_layers=tuple(args.inject_layers),
        )
        out["residual"] = [f["accuracy"] for f in r]
        print("residual:", out["residual"])
    if "linear" not in args.skip:
        r = train_and_eval_linear_head(
            module.model, args.dataset, folds, n_classes, args.save_dir,
        )
        out["linear"] = [f["accuracy"] for f in r]
        print("linear:", out["linear"])

    table = compare_variants(args.save_dir, args.dataset)
    for variant, m in table.items():
        print(
            f"{variant:10s} acc {m['accuracy_mean']:.4f} ± {m['accuracy_std']:.4f} "
            f"(top5 {m.get('top5_accuracy', float('nan')):.4f}, "
            f"F1 {m['f1_macro']:.4f}, folds {m['folds']})"
        )
    with open(f"{args.save_dir}/{args.dataset}_table.json", "w") as f:
        json.dump({k: {kk: vv for kk, vv in v.items() if np.isscalar(vv)} for k, v in table.items()}, f, indent=2)
    out["table"] = table
    return out


if __name__ == "__main__":
    main()
