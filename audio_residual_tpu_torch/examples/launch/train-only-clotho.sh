#!/bin/bash
# Single-host Clotho-only contrastive finetune (the reference's
# `CLAP/experiment_scripts/train-only-clotho.sh`); torchrun starts one
# process a card of this host (NPROC, default 1).
NPROC=${NPROC:-1}

torchrun --standalone --nproc-per-node $NPROC \
    -m audio_residual_tpu_torch.training.main \
    --save-frequency 5 \
    --save-top-performance 3 \
    --save-most-recent \
    --dataset-type webdataset \
    --datasetpath "<dir-containing-Clotho-not-the-path-to-Clotho>" \
    --precision bf16 \
    --batch-size 96 \
    --lr 1e-4 \
    --wd 0.0 \
    --epochs 45 \
    --workers 6 \
    --use-bn-sync \
    --amodel HTSAT-tiny \
    --tmodel roberta \
    --warmup 3200 \
    --datasetnames Clotho \
    --datasetinfos train \
    --top-k-checkpoint-select-dataset "Clotho-test" \
    --top-k-checkpoint-select-metric "mAP@10" \
    --logs logs \
    --seed 3407 \
    --gather-with-grad \
    --optimizer adam \
    --data-filling repeatpad \
    --data-truncating rand_trunc \
    --pretrained-audio "<path-to>/HTSAT-fullset-imagenet-map=0.467.ckpt" \
    --prefetch-factor 2
