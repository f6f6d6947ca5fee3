"""Cross-fold evaluation aggregation + comparison harness.

Port of ``audio_residual_tpu/evaluate/harness.py`` (the reference's
`src/evaluation.py:132-198` ``visualize_eval_metrics``: per-fold .npz
loading, aggregate top-1/top-k accuracy, macro P/R/F1, summed confusion
matrix heatmap; `evaluate/eval_linear_probe.py`: sweep a pretraining run's
checkpoints, track the best probe; `evaluate/eval_dcase.py`:
caption-retrieval scoring from pickled embeddings), on the port's
:mod:`~audio_residual_tpu_torch.evaluate.metrics` and linear probe. numpy
on the host; ``matplotlib`` is imported only where a figure is drawn.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from audio_residual_tpu_torch.evaluate.metrics import classification_metrics, retrieval_metrics

__all__ = [
    "aggregate_eval_metrics",
    "compare_variants",
    "eval_linear_probe_sweep",
    "eval_dcase",
    "eval_dcase_sweep",
    "visualize_eval_metrics",
    "plot_lambda_histogram",
]


def visualize_eval_metrics(
    save_dir: str,
    dataset_name: str,
    n_folds: int,
    inject_layers=(),
    k_top: int = 5,
    *,
    class_names=None,
    fig_path: str | None = None,
) -> dict:
    """Cross-fold metrics + aggregated confusion-matrix heatmap —
    `src/evaluation.py:132-198` with the same .npz filename schema
    (``layers_{l}_evalfold_{i}.npz`` for ResiDual runs, ``evalfold_{i}.npz``
    for baseline/linear). Headless-friendly: pass ``fig_path`` to render the
    heatmap to a file (matplotlib optional import); returns the metrics dict
    either way."""
    layers_str = "_".join(map(str, inject_layers)) if inject_layers else ""
    per_fold = {"acc": [], "topk": [], "prec": [], "rec": [], "f1": []}
    agg_cm = None
    n_classes = None
    for i in range(n_folds):
        name = (
            f"layers_{layers_str}_evalfold_{i}.npz" if layers_str else f"evalfold_{i}.npz"
        )
        data = np.load(os.path.join(save_dir, name))
        sims = data["similarities"]
        y_pred = np.asarray(data["predictions"])
        y_true = np.asarray(data["targets"])
        if n_classes is None:
            n_classes = sims.shape[1]
            agg_cm = np.zeros((n_classes, n_classes), np.int64)
        m = classification_metrics(sims, y_true, topk=min(k_top, n_classes))
        per_fold["acc"].append(float((y_pred == y_true).mean()))
        per_fold["topk"].append(m[f"top{min(k_top, n_classes)}_accuracy"])
        per_fold["prec"].append(m["precision_macro"])
        per_fold["rec"].append(m["recall_macro"])
        per_fold["f1"].append(m["f1_macro"])
        np.add.at(agg_cm, (y_true, y_pred), 1)
    out = {"confusion_matrix": agg_cm, "n_folds": n_folds}
    for k, vals in per_fold.items():
        v = np.asarray(vals, float)
        out[f"{k}_mean"] = float(v.mean())
        out[f"{k}_std"] = float(v.std(ddof=1)) if n_folds > 1 else 0.0
    if fig_path:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(12, 10))
        im = ax.imshow(agg_cm, cmap="Blues")
        fig.colorbar(im, ax=ax)
        if class_names is not None:
            ax.set_xticks(range(n_classes), class_names, rotation=90, fontsize=6)
            ax.set_yticks(range(n_classes), class_names, fontsize=6)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("True")
        ax.set_title("Aggregated Confusion Matrix (sum over folds)")
        fig.tight_layout()
        fig.savefig(fig_path, dpi=120)
        plt.close(fig)
        out["figure"] = fig_path
    return out


def plot_lambda_histogram(lam, fig_path: str, *, title: str = "ResiDual λ") -> str:
    """Render a trained-λ histogram to a file — the file-based equivalent of
    the reference's ``wandb.Histogram(residual.learnable)`` logging
    (`src/training.py:128-135`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lam = np.asarray(lam).ravel()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(lam, bins=min(64, max(8, lam.size // 4)))
    ax.set_xlabel("λ value")
    ax.set_ylabel("count")
    ax.set_title(f"{title} (K={lam.size})")
    fig.tight_layout()
    fig.savefig(fig_path, dpi=120)
    plt.close(fig)
    return fig_path


def aggregate_eval_metrics(npz_dir: str, pattern: str = "*.npz", topk: int = 5) -> dict:
    """Load all per-fold ``.npz`` artifacts (schema: similarities /
    predictions / targets) and aggregate: mean±std accuracy across folds,
    pooled macro P/R/F1, summed confusion matrix (`evaluation.py:132-198`)."""
    files = sorted(glob.glob(os.path.join(npz_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no npz artifacts under {npz_dir}/{pattern}")
    accs, all_sims, all_targets = [], [], []
    for f in files:
        data = np.load(f)
        sims, targets = data["similarities"], data["targets"]
        accs.append(float((data["predictions"] == targets).mean()))
        all_sims.append(sims)
        all_targets.append(targets)
    sims = np.concatenate(all_sims)
    targets = np.concatenate(all_targets)
    m = classification_metrics(sims, targets, topk=topk)
    m.update(
        {
            "folds": len(files),
            "accuracy_mean": float(np.mean(accs)),
            "accuracy_std": float(np.std(accs)),
            "per_fold_accuracy": accs,
        }
    )
    return m


def compare_variants(save_dir: str, dataset_name: str,
                     variants=("Baseline", "ResiDual", "Linear")) -> dict:
    """Side-by-side table of the three CLAP variants (PDF Table 1 layout)."""
    out = {}
    for v in variants:
        d = os.path.join(save_dir, dataset_name, v)
        if os.path.isdir(d):
            out[v] = aggregate_eval_metrics(d)
    return out


def eval_linear_probe_sweep(models_by_ckpt: dict, folds, n_classes: int, save_dir: str,
                            **probe_kw) -> dict:
    """For each pretraining checkpoint's model, train + eval a linear probe
    and track the best (`evaluate/eval_linear_probe.py:132-515` semantics).
    ``models_by_ckpt`` maps a name to a ``CLAPAudio`` (which carries its
    config, in place of the JAX package's params and ``cfg``)."""
    from audio_residual_tpu_torch.training.linear_probe import train_and_eval_linear_head

    results = {}
    for name, model in models_by_ckpt.items():
        res = train_and_eval_linear_head(
            model, f"probe_{name}", folds, n_classes, save_dir, **probe_kw
        )
        results[name] = float(np.mean([r["accuracy"] for r in res]))
    best = max(results, key=results.get)
    return {"per_ckpt": results, "best_ckpt": best, "best_acc": results[best]}


def eval_dcase(embeddings_pickle: str) -> dict:
    """DCASE caption-retrieval scoring from pickled output embeddings
    (`evaluate/eval_dcase.py:15-150`): expects {audio_features,
    text_features} arrays, optionally {logit_scale_a}.

    Two layouts, matching the reference CLI:
      * matched 1:1 pairs -> both-direction ``retrieval_metrics``;
      * the Clotho protocol — 5 captions per audio (text rows = 5x audio
        rows, caption i belongs to audio i//5) -> text->audio ranking with
        repeat-interleaved ground truth (`eval_dcase.py:33-48`): mean/median
        rank (1-based), R@1/5/10, mAP@10.
    """
    with open(embeddings_pickle, "rb") as f:
        blob = pickle.load(f)
    a = np.asarray(blob["audio_features"])
    t = np.asarray(blob["text_features"])
    scale = float(blob.get("logit_scale_a", 1.0))
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    if t.shape[0] == a.shape[0]:
        return retrieval_metrics(a, t, logit_scale=scale)
    if t.shape[0] != 5 * a.shape[0]:
        raise ValueError(
            f"text rows ({t.shape[0]}) must equal audio rows ({a.shape[0]}) "
            "or be exactly 5x (the Clotho 5-caption protocol)"
        )
    # logits_per_text [5N, N]; ground truth for caption row i is audio i//5
    logits = scale * (t @ a.T)
    truth = np.repeat(np.arange(a.shape[0]), 5)
    order = np.argsort(-logits, axis=-1)
    preds = np.argmax(order == truth[:, None], axis=-1)  # rank of true audio
    out = {
        "num_samples": int(a.shape[0]),
        "mean_rank": float(preds.mean() + 1),
        "median_rank": float(np.floor(np.median(preds)) + 1),
    }
    for k in (1, 5, 10):
        out[f"R@{k}"] = float(np.mean(preds < k))
    out["mAP@10"] = float(np.mean(np.where(preds < 10, 1.0 / (preds + 1), 0.0)))
    return out


def eval_dcase_sweep(pickle_dir: str, pattern: str = "*.pkl") -> dict:
    """Score every embeddings pickle of a checkpoint directory and track the
    best by text->audio mAP@10 — the reference workflow of running
    `eval_dcase` over each epoch's saved outputs (its CLI scores one
    ``--pretrained`` path per invocation; the sweep loop lived in shell)."""
    files = sorted(glob.glob(os.path.join(pickle_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no embeddings pickles under {pickle_dir}/{pattern}")
    per_ckpt = {os.path.basename(f): eval_dcase(f) for f in files}

    def score(m: dict) -> float:
        return m.get("mAP@10", m.get("text_to_audio_mAP@10", 0.0))

    best = max(per_ckpt, key=lambda k: score(per_ckpt[k]))
    return {"per_ckpt": per_ckpt, "best_ckpt": best, "best_mAP@10": score(per_ckpt[best])}
