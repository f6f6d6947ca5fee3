"""Numeric pieces shared by the kernels' plain PyTorch versions.

Port of the semantics of ``audio_residual_tpu/ops/pallas/common.py``:
LayerNorm with f32 statistics and per-head window attention; exact-erf GELU
is ``F.gelu``. The Abramowitz-Stegun ``erf`` and the head-group packing
there are TPU workarounds and are not carried over.

The AMP contract of the TPU kernels: GEMM operands are rounded to bf16 and
accumulated in f32; LN statistics, scores, softmax and residual adds stay
f32. ``mxu_round`` reproduces that rounding on f32 tensors, so a plain f32
matmul of rounded operands computes what a bf16 x bf16 -> f32 kernel does.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["layer_norm", "mxu_round", "linear", "attention_core", "golden_convs"]


@contextlib.contextmanager
def golden_convs():
    """cuDNN convolutions and cuBLAS products in full f32 (TF32 off) inside
    the block, the port's rule for the PyTorch convolutions of the golden
    path (the JAX package runs them at f32 precision); the previous settings
    come back after it."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def layer_norm(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def mxu_round(t: torch.Tensor, mxu_dtype) -> torch.Tensor:
    """``t`` in f32, rounded through ``mxu_dtype`` when one is set."""
    t = t.float()
    return t if mxu_dtype is None else t.to(mxu_dtype).float()


def linear(x: torch.Tensor, weight: torch.Tensor, bias, mxu_dtype=None) -> torch.Tensor:
    """``x @ weight.T + bias`` in f32 (``weight`` in ``nn.Linear`` layout
    ``[out, in]``), operands rounded per the AMP contract."""
    y = mxu_round(x, mxu_dtype) @ mxu_round(weight, mxu_dtype).t()
    return y if bias is None else y + bias


def attention_core(qkv: torch.Tensor, bias: torch.Tensor, mask, *, nh: int,
                   mxu_dtype=None) -> torch.Tensor:
    """Windowed multi-head attention before the output projection.

    ``qkv [W, n, 3C]`` f32 (q | k | v, heads contiguous in each),
    ``bias [nh, n, n]``, ``mask [nW, n, n]`` or None (window ``w`` takes
    ``mask[w % nW]``) -> ``[W, n, C]`` f32. Exact per-head softmax in f32.
    """
    wn, n, c3 = qkv.shape
    c = c3 // 3
    hd = c // nh
    qkv = qkv.reshape(wn, n, 3, nh, hd)
    q = qkv[:, :, 0].permute(0, 2, 1, 3) * hd**-0.5
    k = qkv[:, :, 1].permute(0, 2, 1, 3)
    v = qkv[:, :, 2].permute(0, 2, 1, 3)
    s = mxu_round(q, mxu_dtype) @ mxu_round(k, mxu_dtype).transpose(-1, -2)
    s = s + bias[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(wn // nw, nw, nh, n, n) + mask[None, :, None]).reshape(wn, nh, n, n)
    p = torch.softmax(s, dim=-1)
    o = mxu_round(p, mxu_dtype) @ mxu_round(v, mxu_dtype)
    return o.permute(0, 2, 1, 3).reshape(wn, n, c)
