"""One-command full-workflow artifact: the complete ResiDual experiment.

Port of ``examples/full_workflow.py``: the reference's whole experiment
pipeline end to end (`2_Apply_ResiDual_to_CLAP.ipynb` cells 12-24 +
`3_Evaluate_and_compare_CLAP_performance.ipynb` cells 9-18 /
`src/evaluation.py:19-198`):

  1. residual-stream PCA per (layer, fold)          (`src/residual.py:103-159`)
  2. ResiDual injection + zero-shot λ-training      (`src/training.py:12-41`)
  3. K-fold eval, ``.npz`` artifacts + trained λ    (`src/evaluation.py:19-71`)
  4. zero-shot baseline eval                        (`src/evaluation.py:112-128`)
  5. frozen-encoder linear probe                    (`src/linear.py:56-124`)
  6. aggregate metrics + confusion heatmap + λ hist (`src/evaluation.py:132-198`)

Runs on a synthetic class-template dataset (no downloads), with either the
full HTSAT-tiny+RoBERTa CLAP (default; random weights unless ``--ckpt``) or
a CPU-sized tiny model (``--size tiny``), golden f32 on the card unless
``main`` is called with ``device="cpu"``. Emits ONE summary line
``WORKFLOW {json}`` with the JAX script's keys, ``checks`` and ``ok`` rule.

One difference by design: without matplotlib the two figures are skipped,
their ``artifacts`` entries are ``null`` and the reason is printed.

Run: ``python -m audio_residual_tpu_torch.examples.full_workflow --size tiny --folds 2``
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import time

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device


def build_model(size: str, seed: int, ckpt: str | None, device=None):
    """``(model, cfg, context)``: ``create_model("HTSAT-tiny", "roberta")``
    (``full``) or the JAX script's tiny CLAP config, random from ``seed``."""
    from audio_residual_tpu_torch.models import clap as clap_mod

    if size == "full":
        from audio_residual_tpu_torch.models import factory

        model, cfg, _ = factory.create_model("HTSAT-tiny", "roberta", ckpt or "", seed=seed,
                                             device=device)
        context = 77
    else:
        from audio_residual_tpu_torch.models.htsat import HTSATConfig
        from audio_residual_tpu_torch.models.roberta import RobertaConfig

        cfg = clap_mod.CLAPConfig(
            embed_dim=64,
            joint_embed_shape=32,
            audio=HTSATConfig(
                spec_size=64, mel_bins=16, embed_dim=32, depths=(1, 1),
                num_heads=(2, 4), clip_samples=24000, num_classes=17,
            ),
            text=RobertaConfig(
                vocab_size=101, hidden_size=32, num_layers=2, num_heads=4,
                intermediate_size=64, max_position_embeddings=40,
            ),
        )
        model = clap_mod.build_clap(cfg, seed=seed, device=device)
        context = 16
    return model, cfg, context


def synth_folds(
    n_classes: int, n_folds: int, per_split: int, clip_len: int, seed: int,
    wav_noise: float = 0.05, template_scale: float = 0.3,
):
    """Class-template synthetic audio: per-class fixed waveform + noise, so
    embeddings are class-separable even under random encoder weights (the
    linear probe must beat chance). Returns ``(folds, templates)``; the
    templates also seed the class-anchored text embeddings. Numpy from the
    seed, the JAX script's draws.

    ``template_scale`` is load-bearing: random encoders map inputs onto a
    dominant common embedding direction, and the class-delta norm of the
    NORMALIZED embeddings is non-monotonic in input amplitude (the log-mel
    frontend saturates at both ends); 0.3 is the JAX script's measured
    sweet spot on the tiny config."""
    rng = np.random.default_rng(seed)
    templates = (
        rng.standard_normal((n_classes, clip_len)) * template_scale
    ).astype(np.float32)

    def make_split(split_seed):
        r = np.random.default_rng(split_seed)
        labels = r.integers(0, n_classes, per_split)
        wav = templates[labels] + (
            r.standard_normal((per_split, clip_len)) * wav_noise
        ).astype(np.float32)

        def gen():
            yield wav.astype(np.float32), labels

        return gen

    return [
        (make_split(1000 + i), make_split(2000 + i)) for i in range(n_folds)
    ], templates


def anchored_text_embeds(
    model, templates: np.ndarray, max_len: int,
    *, wav_noise: float, anchor_noise: float, seed: int,
) -> torch.Tensor:
    """Class-correlated "text" embeddings, ``[n_classes, joint]`` on the
    model's device.

    With random weights, tower-made prompt embeddings are uncorrelated noise
    and zero-shot CE has no gradient. The stand-in for a trained
    checkpoint's text-audio alignment: embed a few noisy clips of each class
    template through the SAME audio encoder, average, center on the common
    direction, then perturb orthogonally to it by ``anchor_noise`` (relative
    to the class-delta norm), so the baseline lands below ceiling and
    λ-training has loss to recover (the JAX script's construction, step for
    step)."""
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import encode_audio

    device = model.audio_projection[0].weight.device
    rng = np.random.default_rng(seed + 77)
    n_classes, clip_len = templates.shape
    n_anchor = 4
    wav = np.repeat(templates, n_anchor, axis=0) + (
        rng.standard_normal((n_classes * n_anchor, clip_len)) * wav_noise
    ).astype(np.float32)
    with torch.no_grad():
        emb = encode_audio(
            model, featurize_batch(torch.from_numpy(wav).to(device), max_len)
        )["normalized"].cpu().numpy()
    means = emb.reshape(n_classes, n_anchor, -1).mean(axis=1)
    # center first: the class-discriminative deltas are what a trained text
    # tower would provide; the shared component would drown them
    common = means.mean(axis=0)
    common_dir = common / np.linalg.norm(common)
    deltas = means - common
    # noise orthogonal to the common direction: a component along it would
    # be a per-anchor constant bias in the similarities
    noise = rng.standard_normal(means.shape).astype(np.float32)
    noise -= np.outer(noise @ common_dir, common_dir)
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True)
    anchors = deltas + anchor_noise * np.linalg.norm(
        deltas, axis=-1, keepdims=True
    ) * noise
    anchors /= np.linalg.norm(anchors, axis=-1, keepdims=True)
    return torch.from_numpy(anchors.astype(np.float32)).to(device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--size", choices=["tiny", "full"], default="full")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out-dir", default="/tmp/full_workflow")
    p.add_argument("--n-classes", type=int, default=5)
    p.add_argument("--folds", type=int, default=2)
    p.add_argument(
        "--per-split", type=int, default=32,
        help="clips per split; 32 gives the linear probe enough labelled "
        "data to dominate the zero-shot baseline (8 leaves classes with "
        "0-1 train samples and the probe at chance)",
    )
    p.add_argument(
        "--epochs", type=int, default=16,
        help="λ-training epochs; 16 x lr 0.05 moves the tiny random model's "
        "zero-shot CE by more than 1e-3 (the learning assertion)",
    )
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument(
        "--layers", type=int, nargs="+", default=None,
        help="injection layers; default = the LAST encoder layer, where λ "
        "leverage on a random-weight model is measurable (with a trained "
        "ckpt the reference's best config [0] applies instead)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--text-source", choices=["anchored", "tower"], default=None,
        help="class-text embeddings: 'anchored' (class-correlated, the "
        "learning-demonstrating default without a ckpt) or 'tower' (the "
        "model's own text tower — the real protocol, needs --ckpt for "
        "meaningful alignment)",
    )
    p.add_argument("--wav-noise", type=float, default=0.05)
    p.add_argument("--template-scale", type=float, default=0.3)
    p.add_argument(
        "--anchor-noise", type=float, default=1.2,
        help="anchor perturbation relative to the class-delta norm: 0 puts "
        "the zero-shot baseline at ceiling, 1.2 lands it materially above "
        "chance but below the linear probe (the Table-1 regime)",
    )
    args = p.parse_args(argv)
    if args.text_source is None:
        args.text_source = "tower" if args.ckpt else "anchored"
    return args


def main(argv=None, *, model=None, device=None) -> dict:
    """Run the workflow; returns the ``WORKFLOW`` summary it prints.
    ``model``: a ready CLAP of the ``--size`` config (its device is the
    run's), in place of :func:`build_model`'s."""
    args = parse_args(argv)

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.evaluate.harness import (
        compare_variants,
        plot_lambda_histogram,
        visualize_eval_metrics,
    )
    from audio_residual_tpu_torch.models.clap import encode_audio, encode_text
    from audio_residual_tpu_torch.residual.analyze import compute_pca_components
    from audio_residual_tpu_torch.training.linear_probe import train_and_eval_linear_head
    from audio_residual_tpu_torch.training.train_residual import (
        evaluate_baseline_clap,
        train_and_evaluate_residual,
    )
    from audio_residual_tpu_torch.utils.cache import enable_compile_cache
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer, load_default_tokenizer

    enable_compile_cache()
    t0 = time.time()
    ds_name = "SYNTH"
    out_dir, pca_dir = os.path.join(args.out_dir, "eval"), os.path.join(args.out_dir, "pca")
    os.makedirs(os.path.join(pca_dir, ds_name), exist_ok=True)

    if model is None:
        model, cfg, context = build_model(args.size, args.seed, args.ckpt,
                                          resolve_device(device))
    else:
        cfg, context = model.cfg, 77 if args.size == "full" else 16
    dev = model.audio_projection[0].weight.device
    if args.layers is None:
        args.layers = [len(cfg.audio.depths) - 1]
    max_len = cfg.audio.clip_samples
    clip_len = max_len // 2  # exercises the repeatpad featurize branch
    folds, templates = synth_folds(
        args.n_classes, args.folds, args.per_split, clip_len, args.seed,
        wav_noise=args.wav_noise, template_scale=args.template_scale,
    )

    if args.text_source == "anchored":
        text_embeds = anchored_text_embeds(
            model, templates, max_len,
            wav_noise=args.wav_noise, anchor_noise=args.anchor_noise,
            seed=args.seed,
        )
    else:
        # class-label text embeddings via the model's own text tower
        # (`hook.get_text_embedding` role; HashTokenizer for the assetless tiny)
        prompts = [f"This is a sound of class {i}." for i in range(args.n_classes)]
        tok = (
            HashTokenizer(cfg.text.vocab_size, context)
            if args.size == "tiny"
            else load_default_tokenizer(context)
        )
        enc = tok(prompts)
        with torch.no_grad():
            text_embeds = encode_text(model, enc["input_ids"], enc["attention_mask"])

    # ---- stage 1: residual-stream PCA per (layer, fold) -------------------
    def encode_taps(wav):
        return encode_audio(model, featurize_batch(wav, max_len), taps=("residual",))

    for fold in range(args.folds):
        train_batches, _ = folds[fold]
        for layer in args.layers:
            compute_pca_components(
                encode_taps,
                (w for w, _ in train_batches()),
                layer,
                cfg.audio.layer_dim(layer),
                save_path=os.path.join(
                    pca_dir, ds_name, f"layer_{layer}_evalfold_{fold}"
                ),
                device=dev,
            )

    # ---- stages 2+3: inject + λ-train + K-fold eval .npz ------------------
    residual_results = train_and_evaluate_residual(
        model, ds_name, folds, text_embeds, pca_dir, out_dir,
        epochs=args.epochs, lr=args.lr, inject_layers=tuple(args.layers),
    )

    # ---- stage 4: zero-shot baseline --------------------------------------
    baseline_results = evaluate_baseline_clap(model, ds_name, folds, text_embeds, out_dir)

    # ---- stage 5: frozen-encoder linear probe -----------------------------
    linear_results = train_and_eval_linear_head(
        model, ds_name, folds, args.n_classes, out_dir,
        epochs=max(args.epochs * 10, 100), lr=1e-2,
    )

    # ---- stage 6: aggregate metrics + figures -----------------------------
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("full_workflow: matplotlib is not installed; the confusion heatmap and "
              "the λ histogram are skipped")
    res_dir = os.path.join(out_dir, ds_name, "ResiDual")
    cm_fig = os.path.join(out_dir, "residual_confusion.png") if figures else None
    res_metrics = visualize_eval_metrics(
        res_dir, ds_name, args.folds, inject_layers=list(args.layers), fig_path=cm_fig
    )
    lam_fig = os.path.join(out_dir, "lambda_hist.png") if figures else None
    with open(os.path.join(res_dir, f"lambda_layer{args.layers[0]}_evalfold_0.pkl"), "rb") as f:
        lam0 = pickle.load(f)["lam"]
    if figures:
        plot_lambda_histogram(np.asarray(lam0), lam_fig)
    compare_variants(out_dir, ds_name)

    acc = lambda rs: float(np.mean([r["accuracy"] for r in rs]))  # noqa: E731
    chance = 1.0 / args.n_classes
    loss_first = float(residual_results[0]["history"][0]["train_loss"])
    loss_last = float(residual_results[0]["history"][-1]["train_loss"])
    summary = {
        "ok": True,
        "size": args.size,
        "dataset": ds_name,
        "folds": args.folds,
        "inject_layers": args.layers,
        "text_source": args.text_source,
        "seconds": round(time.time() - t0, 2),
        "chance": chance,
        "baseline_acc": acc(baseline_results),
        "residual_acc": acc(residual_results),
        "linear_acc": acc(linear_results),
        "residual_metrics": {
            k: float(v)
            for k, v in res_metrics.items()
            if np.isscalar(v) and not isinstance(v, str)
        },
        "train_loss_first": loss_first,
        "train_loss_last": loss_last,
        "train_loss_delta": loss_first - loss_last,
        "lambda_moved": bool(not np.allclose(np.asarray(lam0), 1.0)),
        "artifacts": {
            "npz": sorted(os.listdir(res_dir)),
            "confusion_fig": os.path.getsize(cm_fig) if figures else None,
            "lambda_fig": os.path.getsize(lam_fig) if figures else None,
        },
    }
    # learning assertions: with class-anchored text embeddings the artifact
    # must reproduce the experiment's qualitative Table-1 regime:
    #   (i)  the linear probe separates classes far above chance,
    #   (ii) λ-training moves the zero-shot CE loss materially,
    #   (iii) linear > baseline ≈ residual (baseline itself above chance)
    checks = {
        "lambda_moved": summary["lambda_moved"],
        "loss_finite": bool(np.isfinite(loss_last)),
        "linear_above_chance": summary["linear_acc"] >= min(2 * chance + 0.1, 0.75),
        "loss_moved_materially": summary["train_loss_delta"] > 1e-3,
        "baseline_above_chance": summary["baseline_acc"] > chance + 0.05,
        "linear_beats_baseline": summary["linear_acc"] >= summary["baseline_acc"],
        "residual_tracks_baseline": abs(summary["residual_acc"] - summary["baseline_acc"]) <= 0.25,
    }
    if args.text_source != "anchored":
        # tower embeddings on random weights carry no class signal; only the
        # structural checks apply
        checks = {k: checks[k] for k in ("lambda_moved", "loss_finite", "linear_beats_baseline")}
    summary["checks"] = {k: bool(v) for k, v in checks.items()}
    summary["ok"] = bool(all(checks.values()))
    print("WORKFLOW " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
