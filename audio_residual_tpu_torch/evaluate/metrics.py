"""Evaluation metrics: classification (ESC-50 harness) and retrieval.

A copy of ``audio_residual_tpu/evaluate/metrics.py`` (numpy only; the port
imports nothing of the JAX package). Classification metrics mirror
`src/evaluation.py:132-198` (top-1/top-k accuracy, macro
precision/recall/F1, summed confusion matrix across folds); retrieval
metrics mirror ``get_metrics`` (`training/train.py:504-574`):
mean/median rank, R@1/5/10, mAP@10, both directions.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "classification_metrics", "topk_accuracy", "confusion_matrix",
    "retrieval_metrics", "clap_val_metrics",
]


def topk_accuracy(similarities: np.ndarray, targets: np.ndarray, k: int = 5) -> float:
    topk = np.argsort(-similarities, axis=-1)[:, :k]
    return float((topk == targets[:, None]).any(axis=1).mean())


def confusion_matrix(predictions: np.ndarray, targets: np.ndarray, n_classes: int) -> np.ndarray:
    m = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(m, (targets, predictions), 1)
    return m


def classification_metrics(
    similarities: np.ndarray, targets: np.ndarray, *, topk: int = 5
) -> dict:
    """-> accuracy, top-k accuracy, macro P/R/F1, confusion matrix."""
    preds = similarities.argmax(-1)
    n_classes = similarities.shape[-1]
    cm = confusion_matrix(preds, targets, n_classes)
    tp = np.diag(cm).astype(np.float64)
    support = cm.sum(1).astype(np.float64)
    predicted = cm.sum(0).astype(np.float64)
    # macro averages over classes present (sklearn zero_division=0 behaviour)
    prec = np.divide(tp, predicted, out=np.zeros_like(tp), where=predicted > 0)
    rec = np.divide(tp, support, out=np.zeros_like(tp), where=support > 0)
    denom = prec + rec
    f1 = np.divide(2 * prec * rec, denom, out=np.zeros_like(tp), where=denom > 0)
    return {
        "accuracy": float((preds == targets).mean()),
        f"top{topk}_accuracy": topk_accuracy(similarities, targets, topk),
        "precision_macro": float(prec.mean()),
        "recall_macro": float(rec.mean()),
        "f1_macro": float(f1.mean()),
        "confusion_matrix": cm,
    }


def _ranks(logits: np.ndarray) -> np.ndarray:
    """rank of the ground-truth (diagonal) item per row, 0-based
    (`train.py:517-525` semantics: position of the true pair when sorting
    scores descending)."""
    n = logits.shape[0]
    order = np.argsort(-logits, axis=-1)
    ranks = np.empty(n, dtype=np.int64)
    for i in range(n):
        ranks[i] = int(np.where(order[i] == i)[0][0])
    return ranks


def retrieval_metrics(
    audio_features: np.ndarray, text_features: np.ndarray, logit_scale: float = 1.0
) -> dict:
    """Both-direction retrieval metrics over matched (audio_i, text_i) pairs
    (`train.py:504-574`): mean/median rank (1-based), R@1/5/10, mAP@10."""
    logits_at = logit_scale * audio_features @ text_features.T
    out = {"num_samples": audio_features.shape[0]}
    for name, logits in (("audio_to_text", logits_at), ("text_to_audio", logits_at.T)):
        ranks = _ranks(logits)
        out[f"{name}_mean_rank"] = float(ranks.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(ranks)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((ranks < k).mean())
        out[f"{name}_mAP@10"] = float(np.mean(np.where(ranks < 10, 1.0 / (ranks + 1), 0.0)))
    return out


def clap_val_metrics(
    audio_features: np.ndarray,
    text_features: np.ndarray,
    logit_scale_a: float,
    audio_features_mlp: np.ndarray | None = None,
    text_features_mlp: np.ndarray | None = None,
    logit_scale_t: float | None = None,
    mlp_loss: bool = False,
) -> dict:
    """``get_metrics`` (`train.py:504-574`) for the in-training validation
    pass: cumulative CE loss over the FULL val similarity matrix (2-term, or
    4-term under ``mlp_loss``) + both-direction ranking metrics. Under
    ``mlp_loss`` the rankings use the two logit matrices AVERAGED
    (`train.py:537-540`)."""

    def _ce(logits):
        logits = logits - logits.max(axis=-1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=-1, keepdims=True))
        return float(-np.mean(np.diag(logp)))

    n = audio_features.shape[0]
    out = {"num_samples": n}
    if mlp_loss:
        a_l_audio = logit_scale_a * audio_features @ text_features_mlp.T
        t_l_audio = logit_scale_t * audio_features_mlp @ text_features.T
        out["cumulative_loss"] = (
            _ce(a_l_audio) + _ce(a_l_audio.T) + _ce(t_l_audio) + _ce(t_l_audio.T)
        ) / 4.0
        logits = {
            "audio_to_text": (a_l_audio + t_l_audio) / 2.0,
            "text_to_audio": (a_l_audio.T + t_l_audio.T) / 2.0,
        }
    else:
        l_audio = logit_scale_a * audio_features @ text_features.T
        out["cumulative_loss"] = (_ce(l_audio) + _ce(l_audio.T)) / 2.0
        logits = {"audio_to_text": l_audio, "text_to_audio": l_audio.T}

    for name, logit in logits.items():
        ranks = _ranks(logit)
        out[f"{name}_mean_rank"] = float(ranks.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(ranks)) + 1)
        for k in (1, 5, 10):
            out[f"{name}_R@{k}"] = float((ranks < k).mean())
        out[f"{name}_mAP@10"] = float(np.mean(np.where(ranks < 10, 1.0 / (ranks + 1), 0.0)))
    return out
