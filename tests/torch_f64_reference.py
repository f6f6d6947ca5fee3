"""Float64 evaluations of the functions of K1-K5, on the same f32
weights and constants as the port's kernels: what the card tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` measure the golden
routes' errors against. Imports neither JAX nor the JAX package."""

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops import frontend as fe
from audio_residual_tpu_torch.ops.cuda import frontend as k1
from audio_residual_tpu_torch.ops.cuda import window_attention as k2


def error_ratio(got, plain, ref64) -> tuple[float, float, float]:
    """``(max |kernel - f64|, max |plain - f64|, their ratio)``."""
    err = float((got.double() - ref64).abs().max())
    plain_err = float((plain.double() - ref64).abs().max())
    return err, plain_err, err / plain_err


def layer_norm64(t, scale, bias, eps=1e-5):
    mu = t.mean(-1, keepdim=True)
    var = ((t - mu) ** 2).mean(-1, keepdim=True)
    return (t - mu) / torch.sqrt(var + eps) * scale.double() + bias.double()


def ffn64(x, a, n2s, n2b, w1, b1, w2, b2, rp, double_ffn):
    """K3's function on [R, C] rows: [ResiDual] h = x + a, h + FFN(LN2(h))
    [-> the double FFN]."""
    x, a = x.double(), a.double()
    if rp is not None:
        basis = rp["basis"].double()
        a = ((a - rp["mean"].double()) @ basis.t() * rp["lam"].double()) @ basis
    h1 = x + a

    def ffn(t):
        hid = F.gelu(layer_norm64(t, n2s, n2b) @ w1.double().t() + b1.double())
        return hid @ w2.double().t() + b2.double()

    y = h1 + ffn(h1)
    if double_ffn:
        y2 = x + y
        y = y2 + ffn(y2)
    return y


def attention64(y, wqkv, bqkv, wproj, bproj, table, nh, window, shift, resolution):
    """The window attention of K2 and K5 on windows ``y [W, n, C]``: qkv,
    per-head softmax(q k^T hd^-1/2 + relative bias + shift mask) v, proj;
    ``[W * n, C]``."""
    wqkv, bqkv, wproj, bproj = (t.double() for t in (wqkv, bqkv, wproj, bproj))
    bias, mask = k2.bias_and_mask(table, window, shift, resolution)
    wn, n, c = y.shape
    hd = c // nh
    qkv = (y.double() @ wqkv.t() + bqkv).reshape(wn, n, 3, nh, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    s = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias.double()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(wn // nw, nw, nh, n, n) + mask.double()[None, :, None]).reshape(
            wn, nh, n, n)
    o = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3).reshape(wn * n, c)
    return o @ wproj.t() + bproj


def block64(x, flat, rp, nh, window, shift, resolution, double_ffn):
    """K4's function on windows ``x [W, n, C]``: LN1, :func:`attention64`,
    then :func:`ffn64`."""
    wn, n, c = x.shape
    y = layer_norm64(x.double(), flat[0].double(), flat[1].double())
    a = attention64(y, *flat[2:6], flat[12], nh, window, shift, resolution)
    return ffn64(x.reshape(-1, c), a, *flat[6:12], rp, double_ffn).reshape(wn, n, c)


def logmel64(wav, cfg):
    """K1's function on the kernels' f32 constants: frames, the DFT over the
    mel-active bins, power, mel, dB."""
    basis, melw = (torch.from_numpy(t).to(wav.device).double() for t in k1._constants(cfg))
    nb = melw.shape[0]
    frames = fe.reflect_pad(wav.double(), cfg.n_fft // 2).unfold(-1, cfg.n_fft, cfg.hop_length)
    d = frames @ basis
    mel = (d[..., :nb] ** 2 + d[..., nb:] ** 2) @ melw
    return 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin)) - k1._db_offset(cfg)
