"""Zero-shot audio classification evaluation.

A copy of ``audio_residual_tpu/evaluate/zero_shot.py`` (numpy over a
:class:`~audio_residual_tpu_torch.module.CLAPModule`). Reference:
`evaluate/eval_zeroshot_classification.py:28-261` — embed the val set,
build a text classifier from ``"This is a sound of {label}."`` prompts
(GTZAN: ``"This is a {t} song."``), rank, report R@k / mAP@10 / mean rank
per dataset. This is the path behind the reference's headline ESC-50 zero-shot
numbers (`CLAP/README.md:257-261`).
"""

from __future__ import annotations

import logging

import numpy as np

from audio_residual_tpu_torch.evaluate.metrics import classification_metrics

__all__ = ["build_text_classifier", "evaluate_zeroshot", "PROMPT_TEMPLATES"]

PROMPT_TEMPLATES = {
    "default": "This is a sound of {}.",
    "GTZAN": "This is a {} song.",
}


def build_text_classifier(module, class_names: list[str], dataset: str = "default"):
    """-> [C, 512] normalised text embeddings for the class prompts."""
    template = PROMPT_TEMPLATES.get(dataset, PROMPT_TEMPLATES["default"])
    prompts = [template.format(c.replace("_", " ")) for c in class_names]
    return module.get_text_embedding(prompts)


def evaluate_zeroshot(
    module,
    batches,
    class_names: list[str],
    *,
    dataset: str = "default",
    topk: int = 5,
) -> dict:
    """Embed every (wav, label) batch, classify against class prompts, return
    classification + rank metrics."""
    text_embeds = build_text_classifier(module, class_names, dataset)
    sims_all, targets_all = [], []
    for wav, labels in batches:
        emb = module.get_audio_embedding_from_data(np.asarray(wav))
        sims_all.append(emb @ text_embeds.T)
        targets_all.append(np.asarray(labels))
    sims = np.concatenate(sims_all)
    targets = np.concatenate(targets_all)
    m = classification_metrics(sims, targets, topk=topk)
    # rank metrics in the reference's reporting style
    order = np.argsort(-sims, axis=-1)
    ranks = np.array([int(np.where(order[i] == targets[i])[0][0]) for i in range(len(targets))])
    m.update(
        {
            "mean_rank": float(ranks.mean() + 1),
            "median_rank": float(np.floor(np.median(ranks)) + 1),
            **{f"R@{k}": float((ranks < k).mean()) for k in (1, 5, 10)},
            "mAP@10": float(np.mean(np.where(ranks < 10, 1.0 / (ranks + 1), 0.0))),
        }
    )
    logging.info("zero-shot %s: %s", dataset, {k: v for k, v in m.items() if np.isscalar(v)})
    return m
