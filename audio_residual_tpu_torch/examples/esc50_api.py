"""Zero-shot ESC-50 via the pip-style module API.

Port of ``examples/esc50_api.py`` (the reference's
`CLAP/experiment_scripts/esc50_api.py`): loads extracted ESC-50 test shards
(audio + json pairs), embeds audio and the "This is a sound of {label}"
prompts through :class:`~audio_residual_tpu_torch.module.CLAPModule`, and
prints retrieval-style metrics (mean/median rank, R@k, mAP@10) — the
protocol of `CLAP/README.md:261`. The metrics are :func:`retrieval_metrics`.

The port decodes PCM WAV only (``data/datasets.py::load_wav``), so it reads
the shards' FLAC files, the ``**/*.flac`` it globs, only once they are
converted to PCM WAV.

Run: ``python -m audio_residual_tpu_torch.examples.esc50_api [test_dir] [class_index.json] [ckpt]``
"""

from __future__ import annotations

import glob
import json
import sys

import numpy as np

from audio_residual_tpu_torch.module import CLAPModule


def retrieval_metrics(audio_embed: np.ndarray, text_embed: np.ndarray,
                      ground_truth_idx: np.ndarray) -> dict:
    """Each clip's rank of its class among ``audio_embed @ text_embed.T``
    (``ground_truth_idx [N, 1]``) -> mean and median rank (1-based), R@1/5/10
    and mAP@10, the JAX script's arithmetic."""
    ranking = np.argsort(audio_embed @ text_embed.T, axis=-1)[:, ::-1]
    preds = np.nonzero(ranking == ground_truth_idx)[1]

    metrics = {"mean_rank": preds.mean() + 1, "median_rank": np.floor(np.median(preds)) + 1}
    for k in (1, 5, 10):
        metrics[f"R@{k}"] = np.mean(preds < k)
    metrics["mAP@10"] = np.mean(np.where(preds < 10, 1 / (preds + 1), 0.0))
    return metrics


def main(argv=None, *, device=None) -> dict:
    """``argv``: ``[test_dir] [class_index_json] [ckpt]`` as the script's
    positional arguments (defaults the JAX script's). Returns the metrics it
    prints."""
    argv = sys.argv[1:] if argv is None else list(argv)
    esc50_test_dir = argv[0] if len(argv) > 0 else "./ESC50_1/test/*/"
    class_index_dict_path = (
        argv[1] if len(argv) > 1 else "class_labels/ESC50_class_labels_indices_space.json"
    )
    ckpt = argv[2] if len(argv) > 2 else None

    model = CLAPModule(enable_fusion=False, device=device)
    model.load_ckpt(ckpt)  # None -> the default published checkpoint, if on disk

    with open(class_index_dict_path) as f:
        class_index_dict = json.load(f)

    audio_files = sorted(glob.glob(esc50_test_dir + "**/*.flac", recursive=True))
    json_files = sorted(glob.glob(esc50_test_dir + "**/*.json", recursive=True))
    tags = []
    for jf in json_files:
        with open(jf) as f:
            tags.append(json.load(f)["tag"][0])
    ground_truth_idx = np.array([class_index_dict[t] for t in tags])[:, None]

    all_texts = ["This is a sound of " + t for t in class_index_dict.keys()]
    text_embed = model.get_text_embedding(all_texts)
    audio_embed = model.get_audio_embedding_from_filelist(x=audio_files)

    metrics = retrieval_metrics(audio_embed, text_embed, ground_truth_idx)
    print(
        "Zeroshot Classification Results: "
        + "\t".join(f"{k}: {round(v, 4):.4f}" for k, v in metrics.items())
    )
    return metrics


if __name__ == "__main__":
    main()
