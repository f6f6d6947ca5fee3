"""K4 ``fused_swin_block``: a whole Swin block in window space (``csrc/swin_block.cu``).

Replaces ``audio_residual_tpu/ops/pallas/swin_block.py::fused_swin_block``.
``x [B*nW, n, C]`` (block input, already rolled and partitioned) ->
``y = h + MLP(LN2(h))`` with ``h = x + proj(attn(LN1(x)))``, the optional
ResiDual epilogue on the attention output (f32) and, with ResiDual on, the
double-FFN quirk. ``flat_params`` = (n1s, n1b, wqkv, bqkv, wproj, bproj,
n2s, n2b, wfc1, bfc1, wfc2, bfc2, rel_bias_table[, rbasis, rmean, rlam]),
weights in ``nn.Linear`` layout.

On the card the kernel is LN1 -> window attention -> residual FFN, the plan
the JAX package declares equivalent (``swin_block.py::_split_block``), with
the attention output kept in f32 between the halves as in the monolithic
TPU kernel. Under AMP the wrapper hands it bf16 copies of the four weight
matrices; its attention half is K2's qkv + attention kernel
(``csrc/window_attention_tc.cuh``, with the padded bias and mask, the wqkv
map and the plan of :func:`.window_attention.amp_plan`) and the proj GEMM,
and it stores the intermediates that only a GEMM reads in bf16
(``csrc/blocks.cuh``). In the golden mode every product -- qkv, proj, fc1,
fc2 -- runs in 3xTF32 on the tensor cores, on weights the wrapper splits
once per weight version (:mod:`.tf32x3`), with the f32 attention core
between qkv and proj. The ResiDual's two products run in 3xTF32 in both
modes, its component count padded to a multiple of 8
(:func:`.tf32x3.residual_operands`).

As in the JAX package, the public function dispatches: from C =
``WIDE_MIN_C`` on (HTSAT-large layer 2) it runs :func:`split_block` --
LN1, then the window attention (K5 at that width), then K3 -- the plan the
JAX package takes where its block kernel does not fit.
"""

from __future__ import annotations

import ctypes

import torch

from audio_residual_tpu_torch.ops.common import layer_norm
from audio_residual_tpu_torch.ops.cuda import build, launch_counts, tf32x3
from audio_residual_tpu_torch.ops.cuda.autograd import Op, Recompute, needs_graph
from audio_residual_tpu_torch.ops.cuda.ln_mlp import (
    fused_residual_ffn,
    residual_ffn_f32,
    residual_inputs,
    residual_operands,
)
from audio_residual_tpu_torch.ops.cuda.window_attention import (
    NO_PLAN,
    WIDE_MIN_C,
    amp_attention_args,
    attention_f32,
    bias_and_mask,
    check_window_shapes,
    fused_window_attention,
    mxu_weights,
    sm_count,
    store_dtype,
)

__all__ = ["fused_swin_block", "swin_block_plain", "swin_block_autograd", "split_block"]


def _unpack(flat_params, use_residual: bool):
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     table, *res) = flat_params
    rparams = None
    if use_residual:
        if len(res) != 3:
            raise ValueError("use_residual needs (rbasis, rmean, rlam) in flat_params")
        rparams = {"basis": res[0], "mean": res[1], "lam": res[2]}
    return (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
            table), rparams


def swin_block_plain(x, flat_params, nh, window, num_windows_per_image, shift, resolution,
                     use_residual, double_ffn, mxu_dtype=None) -> torch.Tensor:
    """Plain version of the kernel (``swin_block.py::_xla_twin`` semantics)."""
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     table), rparams = _unpack(flat_params, use_residual)
    store = store_dtype(x, mxu_dtype)
    wn, n, c = x.shape
    bias, mask = bias_and_mask(table, window, shift, resolution)
    y = layer_norm(x.float(), n1s, n1b)
    a = attention_f32(y, wqkv, bqkv, wproj, bproj, bias, mask, nh, mxu_dtype)
    out = residual_ffn_f32(x.reshape(-1, c), a.reshape(-1, c), n2s, n2b, wfc1, bfc1, wfc2,
                           bfc2, rparams, double_ffn=double_ffn and use_residual,
                           mxu_dtype=mxu_dtype)
    return out.reshape(wn, n, c).to(store)


def split_block(x, flat_params, nh: int, window: int, num_windows_per_image: int, shift: int,
                resolution, use_residual: bool, double_ffn: bool, mxu_dtype=None, *,
                attention=None) -> tuple:
    """The block as LN1 (plain PyTorch, f32 statistics), the window-attention
    kernel (K2, or K5 from ``WIDE_MIN_C``), then the residual-FFN kernel
    (K3): ``swin_block.py::_split_block``, the same function as the block
    kernel. The attention output travels in the store dtype.

    Returns ``(out, a)``: the post-block windows and the attention output
    ``a`` in window space, before the ResiDual (the HTSAT forward's residual
    tap). ``attention``, a function of LN1's output ``[B*nW, n, C]`` (store
    dtype) returning the attention output, runs in place of the
    window-attention kernel (the attention tap's model-level attention,
    which also returns the probabilities)."""
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     table), rparams = _unpack(flat_params, use_residual)
    store = store_dtype(x, mxu_dtype)
    wn, n, c = x.shape
    x = x.to(store)
    # in the store dtype, so that the attention output stays f32 for K3 when
    # the block input is f32 (layer 3 under AMP: PatchMerging's output); K2
    # and K5 round y to bf16 for their GEMMs themselves
    y = layer_norm(x.float(), n1s, n1b).to(store)
    if attention is None:
        a = fused_window_attention(y, wqkv, bqkv, wproj, bproj, table, nh, window,
                                   num_windows_per_image, shift, resolution, mxu_dtype)
    else:
        a = attention(y)
    # the double-FFN quirk exists only in the ResiDual-patched forward
    out = fused_residual_ffn(x.reshape(-1, c), a.reshape(-1, c), n2s, n2b, wfc1, bfc1, wfc2,
                             bfc2, rparams, double_ffn=double_ffn and use_residual,
                             mxu_dtype=mxu_dtype).reshape(wn, n, c)
    return out, a


def fused_swin_block(x, flat_params, nh: int, window: int, num_windows_per_image: int,
                     shift: int, resolution, use_residual: bool, double_ffn: bool,
                     mxu_dtype=None) -> torch.Tensor:
    """``x [B*nW, n, C]`` pre-norm windows -> post-block windows, in the store
    dtype. C >= ``WIDE_MIN_C`` runs :func:`split_block`; other CPU tensors
    take :func:`swin_block_plain`; CUDA tensors with an input that requires
    grad (in grad mode) take :func:`swin_block_autograd`."""
    args = (nh, window, num_windows_per_image, shift, resolution, use_residual, double_ffn,
            mxu_dtype)
    if x.shape[-1] >= WIDE_MIN_C:
        return split_block(x, flat_params, *args)[0]
    if x.device.type == "cpu":
        return swin_block_plain(x, flat_params, *args)
    if needs_graph(x, *flat_params):
        return swin_block_autograd(x, flat_params, *args)
    return _kernel(x, flat_params, *args)


def swin_block_autograd(x, flat_params, nh, window, num_windows_per_image, shift, resolution,
                        use_residual, double_ffn, mxu_dtype=None) -> torch.Tensor:
    """K4 under autograd (:mod:`.autograd`): the kernel forward (the plain
    version for CPU tensors), :func:`swin_block_plain`'s backward
    (``swin_block.py::_fsb_bwd``)."""
    args = (nh, window, num_windows_per_image, shift, resolution, use_residual, double_ffn,
            mxu_dtype)
    kernel = swin_block_plain if x.device.type == "cpu" else _kernel
    op = Op(lambda x_, *fp: kernel(x_, fp, *args),
            lambda x_, *fp: swin_block_plain(x_, fp, *args))
    return Recompute.apply(op, x, *flat_params)


def _kernel(x, flat_params, nh, window, num_windows_per_image, shift, resolution, use_residual,
            double_ffn, mxu_dtype) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, one call, its count."""
    store = store_dtype(x, mxu_dtype)
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     table), rparams = _unpack(flat_params, use_residual)
    check_window_shapes("fused_swin_block", x, nh, window, num_windows_per_image, table)
    wn, n, c = x.shape
    hidden = wfc1.shape[0]
    if (tuple(wqkv.shape) != (3 * c, c) or tuple(wproj.shape) != (c, c)
            or tuple(wfc1.shape) != (hidden, c) or tuple(wfc2.shape) != (c, hidden)):
        raise ValueError("fused_swin_block: weight shapes do not match C")
    weights = {"n1s": n1s, "n1b": n1b, "wqkv": wqkv, "bqkv": bqkv, "wproj": wproj,
               "bproj": bproj, "n2s": n2s, "n2b": n2b, "wfc1": wfc1, "bfc1": bfc1,
               "wfc2": wfc2, "bfc2": bfc2, "rel_bias_table": table,
               **residual_inputs(rparams)}
    build.check_cuda_inputs("fused_swin_block", {"x": x, **weights}, float_only=tuple(weights))
    amp = mxu_dtype is not None
    r = wn * n
    sms = sm_count(x.device)
    res = residual_operands(rparams, c, r, sms)
    if amp:  # the attention half reads LN1's bf16 output, of x's shape
        wqkv, wproj, w1, w2 = mxu_weights(mxu_dtype, wqkv, wproj, wfc1, wfc2)
        bias, mask, plan = amp_attention_args(x, wqkv, table, nh, window, shift, resolution)
        mats = (wqkv.data_ptr(), *tf32x3.NO_OPERAND, bqkv.data_ptr(),
                wproj.data_ptr(), *tf32x3.NO_OPERAND, bproj.data_ptr())
        ffn = (w1.data_ptr(), *tf32x3.NO_OPERAND, bfc1.data_ptr(),
               w2.data_ptr(), *tf32x3.NO_OPERAND, bfc2.data_ptr())
    else:
        bias, mask = bias_and_mask(table, window, shift, resolution)
        plan = NO_PLAN
        qkv, proj = tf32x3.operand(wqkv, r, sms), tf32x3.operand(wproj, r, sms)
        mats = (*qkv.args(), bqkv.data_ptr(), *proj.args(), bproj.data_ptr())
        fc1, fc2 = tf32x3.operand(wfc1, r, sms), tf32x3.operand(wfc2, r, sms)
        ffn = (*fc1.args(), bfc1.data_ptr(), *fc2.args(), bfc2.data_ptr())
    kr = res.kr if res is not None else 0
    out = torch.empty(wn, n, c, device=x.device, dtype=store)
    ws_size = build.bind("swin_block", "arpu_swin_block_workspace", "iiiii",
                         restype=ctypes.c_size_t)(r, c, hidden, kr, int(amp))
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    fn = build.bind("swin_block", "arpu_swin_block",
                    "pipi" "iiiiii" "pp" "ppiip" "ppiip" "pp" "ppiip" "ppiip" "pp" "piiiii"
                    "ppii" "ppii" "ppi" "ii" "pp")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            int(store == torch.bfloat16), r, n, c, nh, num_windows_per_image, hidden,
            n1s.data_ptr(), n1b.data_ptr(), *mats, n2s.data_ptr(), n2b.data_ptr(), *ffn,
            bias.data_ptr(), build.ptr(mask), *plan,
            *(res.args() if res is not None else tf32x3.NO_RESIDUAL),
            int(bool(double_ffn and use_residual)), int(amp), ws.data_ptr(), build.stream_of(x))
    build.check("swin_block", rc, "fused_swin_block")
    launch_counts["fused_swin_block"] += 1
    return out
