"""Plain reference of the zero-shot audio path: HTSAT (arXiv:2202.00874) as
LAION-CLAP runs it, with the ResiDual (arXiv:2411.00246) on a layer's
attention output, the audio projection and the L2 normalisation.

Written from the published description in plain PyTorch and numpy; it
imports nothing of the program. It takes the configuration file of the
benchmark and a ``state_dict`` in the reference LAION-CLAP layout
(``audio_branch.layers.{i}.blocks.{j}.attn.qkv.weight``, ...), made by the
benchmark from the seed.

Every product goes through :func:`mm`, whose operands are rounded to the
precision a :class:`Precision` names before an f32 product (TF32 off): the
reference runs at ``"f32"``, and the controls of the correctness check put
it at the precision below the one the cell states (``"tf32"`` below f32,
``"fp8"`` below bf16).

The frontend is torchlibrosa's: periodic Hann window, centred frames with
reflect padding, the power spectrum at every DFT bin, the Slaney mel
filterbank (librosa), ``10 log10(max(x, 1e-10))``; then ``bn0`` with its
eval statistics and the bicubic ``align_corners`` stretch of time to
``spec_size * freq_ratio`` folded into the square Swin image. A LAION-CLAP
block quirk is kept where the ResiDual is injected: the patched block runs
its FFN twice (``x + y`` after the first, then the FFN again).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Precision", "mm", "quantize_int16", "repeat_pad", "logmel", "wav_to_image",
           "encode", "l2_normalize", "mel_filterbank"]

PRECISIONS = ("f32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


class Precision:
    """The operand rounding of every product: ``"f32"`` none, ``"bf16"``,
    ``"fp8"`` (e4m3 with one scale per operand), ``"tf32"``: on the card
    the tensor cores' own TF32 (``allow_tf32`` inside :meth:`context`), on
    the CPU operands rounded to 10 mantissa bits, the gradient passed
    straight through."""

    def __init__(self, name: str = "f32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r} is not one of {PRECISIONS}")
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.name == "f32" or (self.name == "tf32" and t.is_cuda):
            return t
        if self.name == "bf16":
            return t.to(torch.bfloat16).float()
        if self.name == "tf32":
            bits = t.detach().contiguous().view(torch.int32)
            rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
            return t + (rounded - t).detach()
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).float() * scale

    @contextlib.contextmanager
    def context(self):
        """TF32 on for the card's products while the block runs, for
        ``"tf32"``; off (the benchmark's setting) otherwise."""
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """``a @ b`` on operands rounded by ``prec``, accumulated in f32."""
    return prec.round(a) @ prec.round(b)


def linear(x, w, b, prec: Precision):
    y = mm(x, w.t(), prec)
    return y if b is None else y + b


def layer_norm(x, w, b, eps: float = 1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def l2_normalize(x, eps: float = 1e-12):
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps * eps))


def quantize_int16(x):
    """The int16 storage round trip: clamp to [-1, 1], scale by 32767,
    truncate toward zero, scale back."""
    return torch.trunc(torch.clamp(x, -1.0, 1.0) * 32767.0) / 32767.0


def repeat_pad(wav, max_len: int):
    """A clip shorter than ``max_len`` repeated whole ``max_len // T``
    times, then zero-padded (LAION-CLAP's ``repeatpad``)."""
    t = wav.shape[-1]
    if t >= max_len:
        return wav[..., :max_len]
    reps = wav.repeat(1, max_len // t)
    return F.pad(reps, (0, max_len - reps.shape[-1]))


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa's ``filters.mel(htk=False, norm="slaney")``, transposed to
    ``[n_fft // 2 + 1, n_mels]``."""
    fft_f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    w = np.zeros((n_mels, fft_f.size))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        rise = (fft_f - lo) / (c - lo)
        fall = (hi - fft_f) / (hi - c)
        w[m] = np.maximum(0.0, np.minimum(rise, fall)) * (2.0 / (hi - lo))
    return w.T


def _dft_basis(n_fft: int) -> np.ndarray:
    """``[n_fft, 2 * (n_fft // 2 + 1)]``: the periodic-Hann-windowed cos and
    sin of every bin."""
    n = np.arange(n_fft)
    window = 0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)
    k = np.arange(n_fft // 2 + 1)
    ang = 2 * np.pi * np.outer(n, k) / n_fft
    return np.concatenate([np.cos(ang), np.sin(ang)], 1) * window[:, None]


def logmel(wav, a: dict, prec: Precision):
    """``[B, T]`` -> ``[B, frames, n_mels]`` dB."""
    n_fft, hop = a["n_fft"], a["hop_size"]
    x = F.pad(wav.float()[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    basis = torch.tensor(_dft_basis(n_fft), dtype=torch.float32, device=wav.device)
    spec = mm(frames, basis, prec)
    nb = n_fft // 2 + 1
    power = spec[..., :nb] ** 2 + spec[..., nb:] ** 2
    fb = torch.tensor(mel_filterbank(a["sample_rate"], n_fft, a["mel_bins"], a["fmin"],
                                     a["fmax"]), dtype=torch.float32, device=wav.device)
    return 10.0 * torch.log10(torch.clamp(mm(power, fb, prec), min=1e-10))


def wav_to_image(wav, sd: dict, a: dict, prec: Precision):
    """Waveform -> the Swin image ``[B, 1, spec, spec]``: log-mel, ``bn0``,
    bicubic stretch of time, the time axis folded ``freq_ratio`` times onto
    the frequency axis."""
    p = "audio_branch.bn0."
    x = logmel(wav, a, prec)
    x = ((x - sd[p + "running_mean"]) / torch.sqrt(sd[p + "running_var"] + 1e-5)
         * sd[p + "weight"] + sd[p + "bias"])
    spec, mels = a["spec_size"], a["mel_bins"]
    ratio = spec // mels
    x = F.interpolate(prec.round(x)[:, None], size=(spec * ratio, mels), mode="bicubic",
                      align_corners=True)[:, 0]  # [B, spec * ratio, mels]
    b = x.shape[0]
    x = x.transpose(1, 2).reshape(b, mels, ratio, spec).permute(0, 2, 1, 3)
    return x.reshape(b, 1, ratio * mels, spec)


def _relative_index(w: int, device) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    c = torch.stack([ys.flatten(), xs.flatten()])  # [2, w*w]
    d = c[:, :, None] - c[:, None, :] + (w - 1)
    return (d[0] * (2 * w - 1) + d[1]).to(device)


def _shift_mask(res: int, w: int, s: int, device) -> torch.Tensor:
    """``[nW, w*w, w*w]``: -100 between tokens of different regions of the
    rolled image, 0 within one."""
    img = torch.zeros(res, res)
    bands = (slice(0, -w), slice(-w, -s), slice(-s, None))
    label = 0
    for hs in bands:
        for ws in bands:
            img[hs, ws] = label
            label += 1
    win = img.reshape(res // w, w, res // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    return ((win[:, None, :] != win[:, :, None]).float() * -100.0).to(device)


def _windows(x, w):  # [B, H, W, C] -> [B * nW, w*w, C]
    b, h, ww, c = x.shape
    return x.reshape(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _unwindows(x, w, h, ww):
    c = x.shape[-1]
    b = x.shape[0] // ((h // w) * (ww // w))
    return x.reshape(b, h // w, ww // w, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, c)


def _attention(x, p: str, sd: dict, nh: int, w: int, mask, prec: Precision):
    """Window attention ``[W, n, C]`` -> ``(out, probs [W, nh, n, n])``."""
    wn, n, c = x.shape
    hd = c // nh
    qkv = linear(x, sd[p + "qkv.weight"], sd[p + "qkv.bias"], prec)
    q, k, v = qkv.reshape(wn, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    scores = mm(q * hd ** -0.5, k.transpose(-1, -2), prec)
    table = sd[p + "relative_position_bias_table"]
    scores = scores + table[_relative_index(w, x.device)].permute(2, 0, 1)
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(wn // nw, nw, nh, n, n) + mask[None, :, None]).reshape(
            wn, nh, n, n)
    probs = torch.softmax(scores, -1)
    out = mm(probs, v, prec).transpose(1, 2).reshape(wn, n, c)
    return linear(out, sd[p + "proj.weight"], sd[p + "proj.bias"], prec), probs


def _residual(a, r: dict, prec: Precision):
    """ResiDual: ``((a - mean) @ basis.T * lam) @ basis``."""
    return mm(mm(a - r["mean"], r["basis"].t(), prec) * r["lam"], r["basis"], prec)


def _block(x, p: str, sd: dict, res: int, nh: int, w: int, shift: int, r, prec: Precision):
    b, n, c = x.shape

    def ffn(t):
        t = layer_norm(t, sd[p + "norm2.weight"], sd[p + "norm2.bias"])
        t = F.gelu(linear(t, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"], prec))
        return linear(t, sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"], prec)

    y = layer_norm(x, sd[p + "norm1.weight"], sd[p + "norm1.bias"]).reshape(b, res, res, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    mask = _shift_mask(res, w, shift, x.device) if shift else None
    a, probs = _attention(_windows(y, w), p + "attn.", sd, nh, w, mask, prec)
    a = _unwindows(a, w, res, res)
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    a = a.reshape(b, n, c)
    if r is None:
        h = x + a
        return h + ffn(h), probs
    h = x + _residual(a, r, prec)
    y = h + ffn(h)
    y2 = x + y  # the patched block's double FFN
    return y2 + ffn(y2), probs


def _merge(x, p: str, sd: dict, res: int, prec: Precision):
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    x = layer_norm(x.reshape(b, -1, 4 * c), sd[p + "norm.weight"], sd[p + "norm.bias"])
    return linear(x, sd[p + "reduction.weight"], None, prec)


def encode(wav, sd: dict, cfg: dict, *, residual: dict | None = None, prec: Precision,
           quantize: bool, taps: bool = False) -> dict:
    """Clips ``[B, T]`` -> ``{"normalized": [B, J]}`` and, with ``taps``,
    ``"attention"``: per layer the mean over its blocks of the attention
    probabilities ``[B * nW, heads, n, n]``. ``residual``: ``{layer:
    {"basis", "mean", "lam"}}``, applied in every block of the layer."""
    with prec.context():
        return _encode(wav, sd, cfg, residual, prec, quantize, taps)


def _encode(wav, sd, cfg, residual, prec, quantize, taps):
    a = cfg["audio"]
    wav = quantize_int16(wav) if quantize else wav.float()
    x = wav_to_image(repeat_pad(wav, a["clip_samples"]), sd, a, prec)
    pa = a["patch_size"]
    b = x.shape[0]
    g = a["spec_size"] // pa
    patches = x.reshape(b, g, pa, g, pa).permute(0, 1, 3, 2, 4).reshape(b, g * g, pa * pa)
    kernel = sd["audio_branch.patch_embed.proj.weight"].reshape(a["embed_dim"], pa * pa)
    x = linear(patches, kernel, sd["audio_branch.patch_embed.proj.bias"], prec)
    x = layer_norm(x, sd["audio_branch.patch_embed.norm.weight"],
                   sd["audio_branch.patch_embed.norm.bias"])
    attention = []
    layers = len(a["depths"])
    for i in range(layers):
        res = g >> i
        w = min(a["window_size"], res)
        r = residual.get(i) if residual else None
        probs_sum = None
        for j in range(a["depths"][i]):
            shift = a["window_size"] // 2 if (j % 2 and res > a["window_size"]) else 0
            x, probs = _block(x, f"audio_branch.layers.{i}.blocks.{j}.", sd, res,
                              a["num_heads"][i], w, shift, r, prec)
            if taps:
                probs_sum = probs if probs_sum is None else probs_sum + probs
        if taps:
            attention.append(probs_sum / a["depths"][i])
        if i < layers - 1:
            x = _merge(x, f"audio_branch.layers.{i}.downsample.", sd, res, prec)
    x = layer_norm(x, sd["audio_branch.norm.weight"], sd["audio_branch.norm.bias"])
    latent = x.mean(1)
    h = F.relu(linear(latent, sd["audio_projection.0.weight"], sd["audio_projection.0.bias"],
                      prec))
    proj = linear(h, sd["audio_projection.2.weight"], sd["audio_projection.2.bias"], prec)
    out = {"normalized": l2_normalize(proj)}
    if taps:
        out["attention"] = attention
    return out
