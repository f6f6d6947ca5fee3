"""Zero-shot classification CLI:
``python -m audio_residual_tpu_torch.evaluate.eval_zeroshot_classification``.

Port of ``audio_residual_tpu/evaluate/eval_zeroshot_classification.py``
(the reference's `evaluate/eval_zeroshot_classification.py:95-261`): a
:class:`~audio_residual_tpu_torch.module.CLAPModule`, each checkpoint of
``--pretrained`` (or the seeded weights), every fold's validation clips
(``data/datasets.py::get_fold_loaders``) through ``evaluate_zeroshot``.
``--enable-fusion`` embeds through the fusion mel stack.
"""

from __future__ import annotations

import argparse
import json
import logging

from audio_residual_tpu_torch.data.datasets import DATASETS, get_fold_loaders
from audio_residual_tpu_torch.evaluate.zero_shot import evaluate_zeroshot
from audio_residual_tpu_torch.module import CLAPModule
from audio_residual_tpu_torch.training.logger import setup_logging

__all__ = ["main"]


def main(argv=None, *, device: str | None = None, tokenizer=None, compute_dtype=None) -> dict:
    """The CLI; ``device``: None is the card, ``"cpu"`` the plain versions on
    the CPU; ``tokenizer`` replaces ``load_default_tokenizer``;
    ``compute_dtype`` is the module's AMP mode. Returns ``{checkpoint or
    "init": metrics}``."""
    p = argparse.ArgumentParser()
    p.add_argument("--amodel", default="HTSAT-tiny")
    p.add_argument("--tmodel", default="roberta")
    p.add_argument("--pretrained", default=None, help="checkpoint path(s)", nargs="*")
    p.add_argument("--dataset", default="ESC50", choices=list(DATASETS))
    p.add_argument("--datasetpath", default=".")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--enable-fusion", action="store_true")
    p.add_argument("--out", default=None, help="write metrics json here")
    args = p.parse_args(argv)

    setup_logging()
    module = CLAPModule(enable_fusion=args.enable_fusion, amodel=args.amodel, tmodel=args.tmodel,
                        tokenizer=tokenizer, compute_dtype=compute_dtype, device=device)
    results = {}
    for ckpt in args.pretrained or [None]:
        if ckpt:
            module.load_ckpt(ckpt)
        folds = get_fold_loaders(args.dataset, args.datasetpath, args.batch_size)

        def all_batches():
            for _, val in folds:
                yield from val()

        m = evaluate_zeroshot(module, all_batches(), DATASETS[args.dataset]["class_labels"],
                              dataset=args.dataset)
        m.pop("confusion_matrix", None)
        results[ckpt or "init"] = m
        logging.info("%s: %s", ckpt, m)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
