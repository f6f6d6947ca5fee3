"""Retrieval eval CLI: ``python -m audio_residual_tpu_torch.evaluate.eval_retrieval_main``.

Port of ``audio_residual_tpu/evaluate/eval_retrieval_main.py`` (the
reference's `evaluate/eval_retrieval_main.py:19-257`, a sweep over a run's
checkpoints, and `eval_retrieval.py:17-192`, one checkpoint): a
``CLAPModule`` on ``--device`` (the card unless ``cpu``), the split's tar
shards through ``data/shards.py`` (epoch 0: a fixed shard order and fixed
crops), ``evaluate/retrieval.py``'s metrics for each checkpoint, and the
best by ``--metric``. ``--params-txt`` recovers ``amodel`` / ``tmodel``
from a training run's ``params.txt``.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

from audio_residual_tpu_torch.data.shards import ShardedAudioText, resolve_tar_paths
from audio_residual_tpu_torch.evaluate.retrieval import evaluate_retrieval, select_top_metric
from audio_residual_tpu_torch.module import CLAPModule
from audio_residual_tpu_torch.training.logger import setup_logging

__all__ = ["read_params_txt", "main"]


def read_params_txt(path: str) -> dict:
    """A training run's ``params.txt`` (``key: value`` lines) -> dict of str."""
    out = {}
    with open(path) as f:
        for line in f:
            if ": " in line:
                k, v = line.split(": ", 1)
                out[k.strip()] = v.strip()
    return out


def main(argv=None, *, tokenizer=None) -> dict:
    """The CLI -> ``{"history": [metrics of each checkpoint], "best": ...}``.
    ``tokenizer`` replaces ``load_default_tokenizer``."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", default=None, help="sweep every epoch_* checkpoint")
    p.add_argument("--pretrained", default=None, help="single checkpoint")
    p.add_argument("--params-txt", default=None)
    p.add_argument("--amodel", default="HTSAT-tiny")
    p.add_argument("--tmodel", default="roberta")
    p.add_argument("--datasetpath", required=True)
    p.add_argument("--datasetnames", nargs="+", default=["Clotho"])
    p.add_argument("--split", default="test")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--metric", default="text_to_audio_mAP@10")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None, help="'cpu' for the plain versions; the card "
                                                  "by default")
    args = p.parse_args(argv)

    setup_logging()
    if args.params_txt:
        run_params = read_params_txt(args.params_txt)
        args.amodel = run_params.get("amodel", args.amodel)
        args.tmodel = run_params.get("tmodel", args.tmodel)

    module = CLAPModule(amodel=args.amodel, tmodel=args.tmodel, tokenizer=tokenizer,
                        device=args.device)
    paths, _ = resolve_tar_paths(args.datasetpath, args.datasetnames, args.split)
    pipe = ShardedAudioText(
        tar_paths=paths, tokenize=module.tokenize, batch_size=args.batch_size,
        max_len=module.cfg.audio.clip_samples, audio_cfg=module.model_cfg["audio_cfg"],
        device=module.device)

    ckpts = [args.pretrained] if args.pretrained else sorted(
        glob.glob(os.path.join(args.ckpt_dir or ".", "epoch_*")))
    history = []
    for ckpt in ckpts:
        if ckpt:
            module.load_ckpt(ckpt)
        batches = ((b["waveform"], b["text"]) for b in pipe.epoch(0))
        m = evaluate_retrieval(module, batches)
        m["ckpt"] = ckpt
        history.append(m)
        logging.info("%s: %s", ckpt, m)
    best = select_top_metric(history, args.metric)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": history, "best": best}, f, indent=2, default=str)
    return {"history": history, "best": best}


if __name__ == "__main__":
    main()
