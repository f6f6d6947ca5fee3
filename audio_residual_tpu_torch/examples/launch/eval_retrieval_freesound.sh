#!/bin/bash
# Freesound retrieval evaluation sweep over a pretraining run's checkpoints
# (the reference's `CLAP/experiment_scripts/eval_retrieval_freesound.sh`),
# on one card. --datasetpath: the directory that holds the
# freesound_no_overlap_noesc50 tar shards; --ckpt-dir: the run's checkpoint
# directory, every epoch_* in it evaluated. The CLI takes its own flags only:
# the training flags the reference's launch also passes (--dataset-type,
# --precision, --seed, --logs, --data-filling, --data-truncating) are not
# among them, and --split names the split that launch gives as --datasetinfos.
python -m audio_residual_tpu_torch.evaluate.eval_retrieval_main \
    --datasetpath "<dir-containing-freesound_no_overlap_noesc50>" \
    --batch-size 512 \
    --amodel HTSAT-tiny \
    --tmodel roberta \
    --datasetnames freesound_no_overlap_noesc50 \
    --split train \
    --ckpt-dir "/mnt/clap_logs/<run-name>/checkpoints"
