"""Logging and metric sinks, from ``audio_residual_tpu/training/logger.py``.

Reference: `training/logger.py:4-26` (root logger with console + optional
file handler and hostname field), plus the train loop's metric sinks:
``results.jsonl`` appends per eval (`train.py:490-492`), optional
TensorBoard/W&B (`--report-to`, imported only when asked for).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time

__all__ = ["setup_logging", "JsonlWriter", "MetricLogger", "AverageMeter"]


def setup_logging(log_file: str | None = None, level=logging.INFO, include_host: bool = False):
    if include_host:
        fmt = f"%(asctime)s | {socket.gethostname()} | %(levelname)s | %(message)s"
    else:
        fmt = "%(asctime)s | %(levelname)s | %(message)s"
    formatter = logging.Formatter(fmt, datefmt="%Y-%m-%d,%H:%M:%S")
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers = []
    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    root.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)


class AverageMeter:
    """Running average (`train.py:21-37`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class JsonlWriter:
    """``results.jsonl`` appender (`train.py:490-492`)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, record: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps({k: v for k, v in record.items()}) + "\n")


class MetricLogger:
    """Fan-out to jsonl + optional tensorboard/wandb (both gated)."""

    def __init__(self, log_dir: str, report_to: tuple[str, ...] = (), wandb_kwargs=None):
        self.jsonl = JsonlWriter(os.path.join(log_dir, "results.jsonl"))
        self.tb = None
        self.wandb = None
        if "tensorboard" in report_to:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except ImportError:
                logging.warning("tensorboard unavailable; skipping")
        if "wandb" in report_to:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self.wandb = wandb
            except ImportError:
                logging.warning("wandb unavailable; skipping")

    def log(self, metrics: dict, step: int | None = None):
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec["time"] = time.time()
        self.jsonl.write(rec)
        if self.tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(k, v, step)
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)
