"""K3 ``fused_residual_ffn``: the FFN half of a Swin block (``csrc/ln_mlp.cu``).

Replaces ``audio_residual_tpu/ops/pallas/ln_mlp.py::fused_residual_ffn``. On
flattened rows ``x, a [R, C]`` (block input and attention output): the
optional ResiDual epilogue on ``a`` (f32), ``h = x + a``,
``y = h + fc2(GELU(fc1(LN2(h))))``, and with ``double_ffn`` the reference's
patched-forward quirk, a second pass from ``x + y``. Weights in
``nn.Linear`` layout (the kernel takes bf16 copies under AMP). Output in
the store dtype (the caller's under AMP).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops.common import layer_norm, linear
from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.ops.cuda.window_attention import mxu_weights, store_dtype
from audio_residual_tpu_torch.residual.module import residual_apply

__all__ = ["fused_residual_ffn", "residual_ffn_plain"]


def residual_ffn_f32(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams=None, *,
                     double_ffn=False, mxu_dtype=None) -> torch.Tensor:
    a = a.float()
    if rparams is not None:
        a = residual_apply(a, rparams["basis"], rparams["mean"], rparams["lam"])
    h1 = x.float() + a

    def ffn(t):
        z = F.gelu(linear(layer_norm(t, n2s, n2b), wfc1, bfc1, mxu_dtype))
        return linear(z, wfc2, bfc2, mxu_dtype)

    y = h1 + ffn(h1)
    if double_ffn:
        y2 = x.float() + y
        y = y2 + ffn(y2)
    return y


def residual_ffn_plain(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams=None, *,
                       double_ffn=False, mxu_dtype=None) -> torch.Tensor:
    """Plain version of the kernel (the formula of ``ln_mlp.py::_kernel``)."""
    store = store_dtype(x, mxu_dtype)
    return residual_ffn_f32(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams,
                            double_ffn=double_ffn, mxu_dtype=mxu_dtype).to(store)


def residual_pointers(rparams, c: int) -> tuple:
    """``(basis, basis_t, mean, lam, kr)`` for the kernels; Nones without ResiDual."""
    if rparams is None:
        return None, None, None, None, 0
    basis = rparams["basis"]
    if basis.ndim != 2 or basis.shape[1] != c:
        raise ValueError(f"ResiDual basis must be [K, {c}], got {tuple(basis.shape)}")
    kr = basis.shape[0]
    if tuple(rparams["mean"].shape) != (c,) or tuple(rparams["lam"].shape) != (kr,):
        raise ValueError("ResiDual mean must be [C] and lam [K]")
    return basis, basis.t().contiguous(), rparams["mean"], rparams["lam"], kr


def fused_residual_ffn(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams: dict | None = None, *,
                       double_ffn: bool = False, mxu_dtype=None) -> torch.Tensor:
    """``x, a [R, C]`` -> post-block rows ``[R, C]``. CPU tensors take
    :func:`residual_ffn_plain`."""
    if x.device.type == "cpu":
        return residual_ffn_plain(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams,
                                  double_ffn=double_ffn, mxu_dtype=mxu_dtype)
    store = store_dtype(x, mxu_dtype)
    if x.ndim != 2 or a.shape != x.shape:
        raise ValueError(f"fused_residual_ffn: x and a must be [R, C], got {x.shape}, {a.shape}")
    r, c = x.shape
    hidden = wfc1.shape[0]
    if tuple(wfc1.shape) != (hidden, c) or tuple(wfc2.shape) != (c, hidden):
        raise ValueError("fused_residual_ffn: fc1 must be [hidden, C] and fc2 [C, hidden]")
    basis, basis_t, mean, lam, kr = residual_pointers(rparams, c)
    weights = {"n2s": n2s, "n2b": n2b, "wfc1": wfc1, "bfc1": bfc1, "wfc2": wfc2, "bfc2": bfc2,
               "basis": basis, "basis_t": basis_t, "mean": mean, "lam": lam}
    build.check_cuda_inputs("fused_residual_ffn", {"x": x, "a": a, **weights},
                            float_only=tuple(weights))
    amp = mxu_dtype is not None
    wfc1, wfc2 = mxu_weights(mxu_dtype, wfc1, wfc2)
    out = torch.empty(r, c, device=x.device, dtype=store)
    ws_size = build.bind("ln_mlp", "arpu_residual_ffn_workspace", "iiiii",
                         restype=ctypes.c_size_t)(r, c, hidden, kr, int(amp))
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    fn = build.bind("ln_mlp", "arpu_residual_ffn", "pipipi" "iii" "pppppp" "pppp" "iii" "pp")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
            int(a.dtype == torch.bfloat16), out.data_ptr(), int(store == torch.bfloat16),
            r, c, hidden,
            n2s.data_ptr(), n2b.data_ptr(), wfc1.data_ptr(), bfc1.data_ptr(), wfc2.data_ptr(),
            bfc2.data_ptr(),
            build.ptr(basis), build.ptr(basis_t), build.ptr(mean), build.ptr(lam),
            kr, int(bool(double_ffn)), int(amp),
            ws.data_ptr(), build.stream_of(x))
    build.check("ln_mlp", rc, "fused_residual_ffn")
    launch_counts["fused_residual_ffn"] += 1
    return out
