#!/bin/bash
# Large multi-dataset fusion pretrain (the reference's
# `CLAP/experiment_scripts/htsat-roberta-large-dataset-fusion.sh`: 13
# webdataset sources, AFF-2D feature fusion for >10 s audio).
# One torchrun a host, one process a card: training/main.py joins them on
# torch.distributed (NCCL) through the MASTER_ADDR / MASTER_PORT rendezvous
# and torchrun's RANK / WORLD_SIZE / LOCAL_RANK.
#
# SLURM: sbatch --nodes=3 --ntasks-per-node=1 htsat-roberta-large-dataset-fusion.sh (srun starts this script's
# torchrun once a host; set NPROC to the cards of a host).

#SBATCH --comment=clap
#SBATCH --nodes=3
#SBATCH --ntasks-per-node=1
#SBATCH --exclusive
#SBATCH --job-name=clap-htsat-fusion

export MASTER_ADDR=${MASTER_ADDR:-$(scontrol show hostnames "$SLURM_JOB_NODELIST" 2>/dev/null | head -n1)}
export MASTER_PORT=${MASTER_PORT:-12802}
NPROC=${NPROC:-8}

torchrun --nnodes ${SLURM_NNODES:-1} --node-rank ${SLURM_NODEID:-0} --nproc-per-node $NPROC \
    --master-addr $MASTER_ADDR --master-port $MASTER_PORT \
    -m audio_residual_tpu_torch.training.main \
    --save-frequency 5 \
    --save-top-performance 3 \
    --save-most-recent \
    --dataset-type webdataset \
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
    --report-to wandb \
    --wandb-notes "clap-dataset-2#-htsat-roberta-fusion" \
    --datasetnames Clotho audiocaps BBCSoundEffects free_to_use_sounds \
        paramount_motion sonniss_game_effects wesoundeffects \
        freesound_no_overlap_noesc50 audiostock epidemic_sound_effects \
        fsd50k_class_label MACS WavText5K \
    --full-train-dataset BBCSoundEffects free_to_use_sounds paramount_motion \
        sonniss_game_effects wesoundeffects audiostock \
        epidemic_sound_effects fsd50k_class_label \
    --exclude-eval-dataset freesound_no_overlap_noesc50 MACS WavText5K \
        fsd50k_class_label \
    --datasetinfos train unbalanced_train \
    --top-k-checkpoint-select-dataset "Clotho-test" \
    --top-k-checkpoint-select-metric "mAP@10" \
    --logs /mnt/clap_logs \
    --seed 3407 \
    --gather-with-grad \
    --optimizer adam \
    --data-filling repeatpad \
    --data-truncating fusion \
    --enable-fusion \
    --fusion-type aff_2d \
    --pretrained-audio /mnt/audio_pretrained_model/HTSAT-fullset-imagenet-map=0.467.ckpt
