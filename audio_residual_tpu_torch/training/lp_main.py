"""Linear-probe CLI: ``python -m audio_residual_tpu_torch.training.lp_main``.

Port of ``audio_residual_tpu/training/lp_main.py`` (the reference's
`training/lp_main.py:127-643`): the ``--lp-*`` flags of
:mod:`~audio_residual_tpu_torch.training.params`, the dataset's predefined
folds (``data/datasets.py::get_fold_loaders``), and per fold the frozen
encoder's embeddings of both splits computed once, a head trained on them
(``training/linear_probe.py``), and its metrics (``lp_metrics``). As in the
JAX package, the encoder is frozen whatever ``--lp-freeze`` says (a warning
says so) and clips are embedded at 480 000 samples.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from audio_residual_tpu_torch.data.datasets import DATASETS, get_fold_loaders
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.training.linear_probe import (embed_dataset, eval_linear_head,
                                                             train_linear_head)
from audio_residual_tpu_torch.training.logger import MetricLogger, setup_logging
from audio_residual_tpu_torch.training.losses import lp_metrics
from audio_residual_tpu_torch.training.params import parse_args

__all__ = ["main"]


def main(argv=None, *, device: str | None = None) -> dict:
    """The CLI; ``device``: None is the card, ``"cpu"`` the plain versions
    on the CPU. Returns ``{"per_fold": [...], "aggregate": {...}}``."""
    args = parse_args(argv)
    if args.sleep:
        time.sleep(args.sleep)  # `lp_main.py:296`
    model, _, _ = factory.create_model(args.amodel, args.tmodel, args.pretrained,
                                       enable_fusion=args.enable_fusion,
                                       fusion_type=args.fusion_type, device=device)
    log_base = os.path.join(args.logs, args.name or "lp_run")
    os.makedirs(log_base, exist_ok=True)
    setup_logging(os.path.join(log_base, "out.log"))
    metric_logger = MetricLogger(log_base, tuple(filter(None, args.report_to.split(","))))
    dev = next(model.parameters()).device
    ds_name = (args.datasetnames or ["ESC50"])[0]
    n_classes = len(DATASETS[ds_name]["class_labels"]) if ds_name in DATASETS else 527
    folds = get_fold_loaders(ds_name, args.datasetpath or ".", args.batch_size)
    if not args.lp_freeze:
        logging.warning(
            "--lp-freeze not set: joint encoder fine-tuning is not implemented (the probe "
            "trains on embed-once cached features, i.e. the lp_freeze=True regime); "
            "proceeding frozen")
    wanted = tuple(m.strip() for m in args.lp_metrics.split(","))
    results = []
    for i, (train_batches, val_batches) in enumerate(folds):
        tr_x, tr_y = embed_dataset(model, train_batches())
        va_x, va_y = embed_dataset(model, val_batches())
        head, _ = train_linear_head(args.seed + i, tr_x, tr_y, n_classes, epochs=args.epochs,
                                    lr=args.lp_lr, mlp=args.lp_mlp, loss_kind=args.lp_loss,
                                    act=args.lp_act, mixup_alpha=0.5 if args.mixup else 0.0,
                                    device=dev)
        _, targets, sims = eval_linear_head(head, va_x, va_y, act=args.lp_act)
        m = lp_metrics(sims, targets, metrics=wanted)
        m["fold"] = i
        results.append(m)
        metric_logger.log(m, step=i)
        logging.info("fold %d: %s", i, m)
    agg = {k: float(np.mean([r[k] for r in results])) for k in wanted}
    logging.info("aggregate: %s", agg)
    return {"per_fold": results, "aggregate": agg}


if __name__ == "__main__":
    main()
