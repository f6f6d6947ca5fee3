#!/bin/bash
# Multi-host contrastive pretraining of HTSAT-tiny + RoBERTa (the reference's
# `CLAP/experiment_scripts/train-htsat-roberta.sh`, 3 nodes x 8 GPUs).
# One torchrun a host, one process a card: training/main.py joins them on
# torch.distributed (NCCL) through the MASTER_ADDR / MASTER_PORT rendezvous
# and torchrun's RANK / WORLD_SIZE / LOCAL_RANK.
#
# SLURM: sbatch --nodes=4 --ntasks-per-node=1 train-htsat-roberta.sh (srun starts this script's
# torchrun once a host; set NPROC to the cards of a host).

#SBATCH --comment=clap
#SBATCH --nodes=4
#SBATCH --ntasks-per-node=1
#SBATCH --exclusive
#SBATCH --job-name=audio-residual-tpu-torch

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
    --datasetpath /mnt/audio_clip/webdataset_tar \
    --datasetnames audioset Clotho audiocaps \
    --batch-size 96 \
    --lr 1e-4 \
    --wd 0.0 \
    --epochs 45 \
    --warmup 3200 \
    --amodel HTSAT-tiny \
    --tmodel roberta \
    --precision bf16 \
    --report-to tensorboard \
    --logs /mnt/logs
