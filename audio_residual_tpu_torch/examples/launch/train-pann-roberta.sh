#!/bin/bash
# PANN-14 + RoBERTa contrastive pretraining (the reference's
# `CLAP/experiment_scripts/train-pann-roberta.sh`, 3x8 GPUs + NCCL).
# One torchrun a host, one process a card: training/main.py joins them on
# torch.distributed (NCCL) through the MASTER_ADDR / MASTER_PORT rendezvous
# and torchrun's RANK / WORLD_SIZE / LOCAL_RANK.
#
# SLURM: sbatch --nodes=3 --ntasks-per-node=1 train-pann-roberta.sh (srun starts this script's
# torchrun once a host; set NPROC to the cards of a host).

#SBATCH --comment=clap
#SBATCH --nodes=3
#SBATCH --ntasks-per-node=1
#SBATCH --exclusive
#SBATCH --job-name=clap-pann-roberta

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
    --amodel PANN-14 \
    --tmodel roberta \
    --warmup 500 \
    --report-to wandb \
    --wandb-notes "clap-dataset-1#-pann-roberta" \
    --datasetnames Clotho audiocaps \
    --datasetinfos train unbalanced_train \
    --top-k-checkpoint-select-dataset "Clotho-test" \
    --top-k-checkpoint-select-metric "mAP@10" \
    --logs /mnt/clap_logs \
    --seed 3407 \
    --gather-with-grad \
    --optimizer adam \
    --data-filling repeatpad \
    --data-truncating rand_trunc \
    --pretrained-audio /mnt/audio_pretrained_model/PANN-fullset-map=0.439.ckpt
