"""Hand-written CUDA kernels for Hopper, one module per TPU kernel,
``gemm``, the bf16 GEMM they share under AMP, ``linear``, the text tower's
golden dense products and their gradients on the 3xTF32 GEMM, and ``qr``,
the blocked float64 Householder QR of the PCA finalize.

Each kernel module holds the wrapper (checks, allocation, launch on the
current stream), its plain PyTorch version and, for K2-K5 and the bf16
GEMM, the ``Op`` of its autograd (:mod:`.autograd`: the kernel forward, the
plain version's backward). A wrapper runs the plain version only for
tensors on the CPU; for a CUDA tensor it launches the kernel or raises,
through :class:`.autograd.Recompute` when an input requires grad in grad
mode (for K2-K5 and the bf16 GEMM one function makes that choice,
:func:`.autograd.route`).

The modules import one way: :mod:`.build` and :mod:`.autograd` at the
bottom, then :mod:`.tf32x3`, then :mod:`.gemm`, then the kernels (K1
``frontend``, K2 ``window_attention``, K3 ``ln_mlp``, ``linear``, ``qr``),
with K4 ``swin_block`` and K5 ``wide_attention`` above K2 and K3. K2 sends
C >= ``WIDE_MIN_C`` to K5 by an import inside the call.

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
    "linear_tf32x3": ("gemm",
                      "none: the JAX package's text tower runs its dense products as "
                      "x @ kernel outside any Pallas kernel (audio_residual_tpu/models/"
                      "roberta.py:105)"),
    "householder_qr": ("householder_qr",
                       "none: the JAX package whitens by a clamped Gram matrix "
                       "(audio_residual_tpu/ops/pca.py:161)"),
}

launch_counts: collections.Counter = collections.Counter()
