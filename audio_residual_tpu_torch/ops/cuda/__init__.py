"""Hand-written CUDA kernels for Hopper, one module per TPU kernel, and
``gemm``, the bf16 GEMM they share under AMP.

Each kernel module holds the wrapper (checks, allocation, launch on the
current stream), its plain PyTorch version and, for K2-K5, its autograd
entry (:mod:`.autograd`: the kernel forward, the plain version's backward).
A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises, through the autograd entry when an
input requires grad in grad mode.

``launch_counts`` counts, per kernel, the launches made on the card; a run
clears it and reads it afterwards to show which kernels a path went
through.
"""

from __future__ import annotations

import collections

__all__ = ["launch_counts", "KERNELS"]

# wrapper name -> (its CUDA source under csrc/, the TPU kernel it replaces)
KERNELS = {
    "fused_logmel": ("logmel", "audio_residual_tpu/ops/pallas/frontend.py:113"),
    "fused_window_attention": ("window_attention",
                               "audio_residual_tpu/ops/pallas/window_attention.py:285"),
    "fused_residual_ffn": ("ln_mlp", "audio_residual_tpu/ops/pallas/ln_mlp.py:106"),
    "fused_swin_block": ("swin_block", "audio_residual_tpu/ops/pallas/swin_block.py:208"),
    "wide_window_attention": ("wide_attention",
                              "audio_residual_tpu/ops/pallas/window_attention.py:234"),
}

launch_counts: collections.Counter = collections.Counter()
