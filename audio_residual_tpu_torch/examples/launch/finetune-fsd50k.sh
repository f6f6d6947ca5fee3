#!/bin/bash
# FSD50K linear-probe finetune (the reference's
# `CLAP/experiment_scripts/finetune-fsd50k.sh`: PANN-14, MLP head, BCE loss
# and the mAP metric for the multi-label set).
# One host; torchrun starts one process a card (NPROC, default 1).

#SBATCH --comment=clap
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --job-name=clap-finetune-fsd50k

NPROC=${NPROC:-1}

torchrun --standalone --nproc-per-node $NPROC \
    -m audio_residual_tpu_torch.training.lp_main \
    --save-frequency 50 \
    --save-top-performance 3 \
    --save-most-recent \
    --dataset-type webdataset \
    --precision bf16 \
    --warmup 0 \
    --batch-size 160 \
    --lr 1e-4 \
    --wd 0.1 \
    --epochs 100 \
    --workers 4 \
    --use-bn-sync \
    --freeze-text \
    --amodel PANN-14 \
    --tmodel roberta \
    --report-to wandb \
    --wandb-notes "finetune-fsd50k" \
    --datasetnames fsd50k_class_label \
    --datasetinfos train \
    --seed 3407 \
    --logs /mnt/clap_logs \
    --gather-with-grad \
    --lp-loss bce \
    --lp-metrics map \
    --lp-lr 1e-4 \
    --lp-mlp \
    --class-label-path class_labels/FSD50k_class_labels_indices.json \
    --pretrained /mnt/clap_logs/pann-roberta-pretrain/checkpoints \
    --data-filling repeatpad \
    --data-truncating rand_trunc \
    --optimizer adam
