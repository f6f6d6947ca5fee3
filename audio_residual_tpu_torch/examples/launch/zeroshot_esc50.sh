#!/bin/bash
# Zero-shot ESC-50 evaluation (the reference's
# `CLAP/experiment_scripts/zeroshot_esc50.sh`), on one card: pass the
# checkpoint path(s).
python -m audio_residual_tpu_torch.evaluate.eval_zeroshot_classification \
    --amodel HTSAT-tiny --tmodel roberta \
    --dataset ESC50 --datasetpath . \
    --pretrained "$@" \
    --out esc50_zeroshot_metrics.json
