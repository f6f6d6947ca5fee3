"""Audio-text retrieval evaluation.

A copy of ``audio_residual_tpu/evaluate/retrieval.py`` (numpy over a
:class:`~audio_residual_tpu_torch.module.CLAPModule`). Reference:
`training/train.py:266-501` (feature accumulation + per-dataset grouping),
`:504-574` (``get_metrics``), `:577-781` (Clotho/AudioCaps 5-caption
protocol and top-metric selection); CLI entry points
`evaluate/eval_retrieval_main.py` / `eval_retrieval.py`.
"""

from __future__ import annotations

import numpy as np

from audio_residual_tpu_torch.evaluate.metrics import retrieval_metrics

__all__ = ["evaluate_retrieval", "evaluate_multicaption", "select_top_metric"]


def evaluate_retrieval(module, batches, *, logit_scale: float = 1.0) -> dict:
    """Embed matched (wav, texts) batches and compute both-direction metrics."""
    a_all, t_all = [], []
    for wav, texts in batches:
        a_all.append(module.get_audio_embedding_from_data(np.asarray(wav)))
        t_all.append(module.get_text_embedding(list(texts)))
    return retrieval_metrics(np.concatenate(a_all), np.concatenate(t_all), logit_scale)


def evaluate_multicaption(
    audio_features: np.ndarray, text_features: np.ndarray, captions_per_audio: int = 5
) -> dict:
    """Clotho/AudioCaps protocol (`train.py:577-735`): each audio has k
    captions; text->audio ranks each caption against all audios; audio->text
    takes the best caption rank per audio."""
    n_audio = audio_features.shape[0]
    k = captions_per_audio
    if text_features.shape[0] != n_audio * k:
        raise ValueError(f"{text_features.shape[0]} captions for {n_audio} audios x {k}")
    logits = text_features @ audio_features.T  # [n_audio*k, n_audio]
    out: dict = {"num_samples": n_audio}

    # text -> audio: ground truth audio for caption i*k+j is audio i
    t2a_ranks = []
    for i in range(n_audio * k):
        order = np.argsort(-logits[i])
        t2a_ranks.append(int(np.where(order == i // k)[0][0]))
    t2a_ranks = np.asarray(t2a_ranks)

    # audio -> text: best rank among the audio's k captions
    logits_at = logits.T  # [n_audio, n_audio*k]
    a2t_ranks = []
    for i in range(n_audio):
        order = np.argsort(-logits_at[i])
        pos = [int(np.where(order == i * k + j)[0][0]) for j in range(k)]
        a2t_ranks.append(min(pos))
    a2t_ranks = np.asarray(a2t_ranks)

    for name, ranks in (("text_to_audio", t2a_ranks), ("audio_to_text", a2t_ranks)):
        out[f"{name}_mean_rank"] = float(ranks.mean() + 1)
        out[f"{name}_median_rank"] = float(np.floor(np.median(ranks)) + 1)
        for kk in (1, 5, 10):
            out[f"{name}_R@{kk}"] = float((ranks < kk).mean())
        out[f"{name}_mAP@10"] = float(np.mean(np.where(ranks < 10, 1.0 / (ranks + 1), 0.0)))
    return out


def select_top_metric(history: list[dict], key: str = "text_to_audio_mAP@10") -> dict:
    """Track the best epoch by a metric (`train.py:750-781`)."""
    best = max(history, key=lambda m: m.get(key, -np.inf))
    return {"best": best, "metric": key, "value": best.get(key)}
