"""A tiny HTSAT and tiny traffic for the benchmark's CPU tests: the cells'
code paths at sizes a CPU test holds."""

from __future__ import annotations

import copy

from benchmark import core

AUDIO = dict(spec_size=64, patch_size=4, patch_stride=[4, 4], in_chans=1, num_classes=10,
             embed_dim=8, depths=[2, 2], num_heads=[2, 4], window_size=4, mlp_ratio=4.0,
             qkv_bias=True, drop_path_rate=0.1, patch_norm=True, sample_rate=48000,
             clip_samples=9600, mel_bins=16, fmin=50.0, fmax=14000.0, n_fft=1024, hop_size=480)
CONFIG = {"name": "htsat-test", "audio": AUDIO, "tower_width": 16, "joint_embed_dim": 16,
          "mlp_act": "relu"}
TRAFFIC = {
    "embed": dict(batch=4, pool_clips=8, clip_samples=4800, warmup_batches=1, trace_batches=2,
                  split_batches=1, check_batches=2, check_block=2),
    "lambda_train": dict(batch=4, train_clips=12, clip_samples=4800, checked_steps=3,
                         trace_steps=2),
    "analysis": dict(batch=4, fold_clips=6, folds=2, clip_samples=4800, check_top=4),
}


def cell(name: str) -> core.Cell:
    """The cell ``name`` of BENCHMARK.json at the tiny size."""
    c = core.Cell(name)
    c.config = copy.deepcopy(CONFIG)
    c.traffic = {**c.traffic, **TRAFFIC[c.traffic["driver"]]}
    return c
