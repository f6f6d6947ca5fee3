"""Plain reference of LAION-CLAP's contrastive training step (arXiv:2211.06687,
``train-htsat-roberta.sh``) on one rank: HTSAT (arXiv:2202.00874) in its
training forward, RoBERTa in its (:mod:`benchmark.reference.roberta`), the
two-layer MLP projections, the symmetric two-term CLIP loss at the audio
logit scale, the gradients of every parameter by autograd, and AdamW
(Loshchilov & Hutter) written out: the warm-up + cosine rate of the step,
decoupled weight decay on the parameters of two or more dimensions, the
bias-corrected moments, then both logit scales clamped to ln(100).

The audio training forward: the log-mel of :mod:`benchmark.reference.htsat`,
``bn0`` on the batch statistics (biased variance), SpecAugment's time then
frequency stripes zeroed, the bicubic stretch and fold into the Swin image,
the patch embedding, the Swin layers with drop-path on both branches of
every block (``x / (1 - rate) * mask``, block ``k`` at ``linspace(0,
drop_path_rate, blocks)[k]``), the patch merging, the final LayerNorm and
the mean over the tokens. Every random draw comes in as a tensor
(``masks``), so the program's own draws can be fed in.

Written in plain PyTorch and f32 (products through
:func:`benchmark.reference.htsat.mm`; TF32 off, on at ``Precision("tf32")``);
it imports nothing of the program. Departures from the published model and
step, each a cut of what one rank computes, not of the mathematics:

* the loss runs over this rank's pairs only; the published run gathers the
  features of all 24 ranks, and its gradients' all-reduce is absent;
* ``bn0``'s running statistics are not updated (the training forward does
  not read them);
* the heads off the two-term loss (HTSAT's TSCAM head, the MLP transforms,
  ``logit_scale_t``) are not run: their gradient is zero, so AdamW leaves
  them as they are at a weight decay of 0, and with a decay only decays
  them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import htsat as ref
from benchmark.reference import roberta

__all__ = ["is_parameter", "forward", "loss", "train_steps", "lr_at"]

MAX_LOGIT_SCALE = math.log(100.0)
SIDES = ("audio", "text")
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_parameter(key: str) -> bool:
    """A trained parameter of the ``state_dict`` (not a BatchNorm statistic)."""
    return not key.endswith(BUFFERS)


def _stripes(x, axis: int, widths, starts):
    pos = torch.arange(x.shape[axis], device=x.device)
    lo, hi = starts[:, :, None], (starts + widths)[:, :, None]
    keep = ~((pos >= lo) & (pos < hi)).any(1)  # [B, dim]
    shape = [x.shape[0], 1, 1]
    shape[axis] = x.shape[axis]
    return x * keep.float().reshape(shape)


def _drop_path(x, keep, rate: float):
    return x if keep is None else x / (1.0 - rate) * keep.float()[:, None, None]


def _image(wav, w: dict, a: dict, spec, prec: ref.Precision):
    """Waveform -> the Swin image ``[B, 1, spec, spec]`` in training: bn0 on
    the batch statistics, then SpecAugment's stripes ``spec = ((time
    widths, starts), (mel widths, starts))``, each ``[B, stripes]``."""
    p = "audio_branch.bn0."
    x = ref.logmel(wav, a, prec)  # [B, T, mels]
    mean = x.mean((0, 1))
    var = ((x - mean) ** 2).mean((0, 1))
    x = (x - mean) / torch.sqrt(var + 1e-5) * w[p + "weight"] + w[p + "bias"]
    if spec is not None:
        (tw, ts), (fw, fs) = spec
        x = _stripes(_stripes(x, 1, tw, ts), 2, fw, fs)
    size, mels = a["spec_size"], a["mel_bins"]
    ratio = size // mels
    x = F.interpolate(prec.round(x)[:, None], size=(size * ratio, mels), mode="bicubic",
                      align_corners=True)[:, 0]
    b = x.shape[0]
    x = x.transpose(1, 2).reshape(b, mels, ratio, size).permute(0, 2, 1, 3)
    return x.reshape(b, 1, ratio * mels, size)


def _block(x, p: str, w: dict, res: int, nh: int, win: int, shift: int, keep, rate: float,
           prec: ref.Precision):
    b, n, c = x.shape
    y = ref.layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"]).reshape(b, res, res, c)
    if shift:
        y = torch.roll(y, (-shift, -shift), (1, 2))
    mask = ref._shift_mask(res, win, shift, x.device) if shift else None
    a, _ = ref._attention(ref._windows(y, win), p + "attn.", w, nh, win, mask, prec)
    a = ref._unwindows(a, win, res, res)
    if shift:
        a = torch.roll(a, (shift, shift), (1, 2))
    k1, k2 = keep if keep is not None else (None, None)
    h = x + _drop_path(a.reshape(b, n, c), k1, rate)
    t = ref.layer_norm(h, w[p + "norm2.weight"], w[p + "norm2.bias"])
    t = ref.linear(F.gelu(ref.linear(t, w[p + "mlp.fc1.weight"], w[p + "mlp.fc1.bias"], prec)),
                   w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"], prec)
    return h + _drop_path(t, k2, rate)


def _audio(wav, w: dict, cfg: dict, masks: dict, prec: ref.Precision):
    a = cfg["audio"]
    x = _image(wav.float(), w, a, masks.get("spec"), prec)
    pa = a["patch_size"]
    b = x.shape[0]
    g = a["spec_size"] // pa
    patches = x.reshape(b, g, pa, g, pa).permute(0, 1, 3, 2, 4).reshape(b, g * g, pa * pa)
    kernel = w["audio_branch.patch_embed.proj.weight"].reshape(a["embed_dim"], pa * pa)
    x = ref.linear(patches, kernel, w["audio_branch.patch_embed.proj.bias"], prec)
    x = ref.layer_norm(x, w["audio_branch.patch_embed.norm.weight"],
                       w["audio_branch.patch_embed.norm.bias"])
    rates = np.linspace(0.0, a["drop_path_rate"], sum(a["depths"]))
    keeps = masks.get("drop_path") or [None] * len(rates)
    layers, k = len(a["depths"]), 0
    for i in range(layers):
        res = g >> i
        win = min(a["window_size"], res)
        for j in range(a["depths"][i]):
            shift = a["window_size"] // 2 if (j % 2 and res > a["window_size"]) else 0
            x = _block(x, f"audio_branch.layers.{i}.blocks.{j}.", w, res, a["num_heads"][i], win,
                       shift, keeps[k], float(rates[k]), prec)
            k += 1
        if i < layers - 1:
            x = ref._merge(x, f"audio_branch.layers.{i}.downsample.", w, res, prec)
    x = ref.layer_norm(x, w["audio_branch.norm.weight"], w["audio_branch.norm.bias"])
    return x.mean(1)


def _project(x, w: dict, p: str, prec: ref.Precision, slopes=None) -> tuple:
    """The projection: ``(features, z, h)`` with ``z`` the ReLU's input and
    ``h`` its output; ``slopes`` (``[B, J]`` of 0 and 1) sets the ReLU's
    slope at each entry (``h = slopes z``) in place of ``z > 0``."""
    z = ref.linear(x, w[p + "0.weight"], w[p + "0.bias"], prec)
    h = F.relu(z) if slopes is None else z * slopes
    return ref.l2_normalize(ref.linear(h, w[p + "2.weight"], w[p + "2.bias"], prec)), z, h


def forward(batch: dict, w: dict, cfg: dict, masks: dict, prec: ref.Precision,
            slopes: dict | None = None) -> tuple:
    """``(audio features, text features, {side: (z, h)})``, the features
    ``[B, J]`` and L2-normalised, ``z`` and ``h`` each projection's ReLU
    input and output. ``batch``: ``waveform [B, T]``, ``input_ids`` and
    ``attention_mask`` ``[B, L]``; ``masks``: ``"spec"`` (SpecAugment's
    stripes), ``"drop_path"`` (a ``(mask1, mask2)`` pair of ``[B]`` keep
    masks a block, None at rate 0), ``"text"``
    (:func:`benchmark.reference.roberta.encode`'s dropout), each left out or
    None for none; ``slopes``: ``{"audio", "text"}`` ReLU slopes
    (:func:`_project`), or None."""
    slopes = slopes or {}
    audio, za, ha = _project(_audio(batch["waveform"], w, cfg, masks, prec), w,
                             "audio_projection.", prec, slopes.get("audio"))
    pooled = roberta.encode(batch["input_ids"], batch["attention_mask"], w, cfg["text"],
                            masks.get("text"), prec)
    text, zt, ht = _project(pooled, w, "text_projection.", prec, slopes.get("text"))
    return audio, text, {"audio": (za, ha), "text": (zt, ht)}


def loss(audio, text, logit_scale, prec: ref.Precision):
    """The two-term CLIP loss: the mean cross-entropy of ``exp(logit_scale)
    audio @ textᵀ`` against the diagonal, over rows and over columns."""
    logits = ref.mm(torch.exp(logit_scale) * audio, text.t(), prec)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels))


def lr_at(step: int, opt: dict) -> float:
    """The rate of the update after ``step`` updates: linear warm-up to
    ``lr`` over ``warmup`` steps, then a cosine to 0 at ``total_steps``."""
    base, warmup, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warmup:
        return base * (step + 1) / max(warmup, 1)
    return 0.5 * (1 + math.cos(math.pi * (step - warmup) / max(total - warmup, 1))) * base


def train_steps(batches, sd: dict, cfg: dict, masks, opt: dict, start_step: int,
                prec: ref.Precision, resolve=None) -> dict:
    """AdamW steps from the weights ``sd``, one per batch of ``batches`` with
    the draws ``masks[t]``; ``opt``: ``lr``, ``warmup``, ``total_steps``,
    ``betas``, ``eps``, ``weight_decay``. Returns ``{"losses", "grads"
    (per step, {key: gradient}), "params" ({key: value} after the last
    step)}``.

    ``resolve(t, z, dh)``, given step ``t``'s ReLU inputs ``z`` and the
    loss's gradients at their outputs ``dh`` (each ``{side: [B, J]}``),
    may return ReLU slopes (:func:`forward`); the step is then computed
    again with them. It serves a comparison that must take the projections'
    kinks on the side the compared program took, where an input lies within
    round-off of 0 (the derivative there is the round-off's choice)."""
    b1, b2 = opt["betas"]
    params = {k: v.detach().float().clone() for k, v in sd.items() if is_parameter(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    keys = list(params)
    out = {"losses": [], "grads": []}
    for t, (batch, draws) in enumerate(zip(batches, masks), start=1):
        slopes = None
        while True:
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            with prec.context():
                audio, text, inner = forward(batch, leaves, cfg, draws, prec, slopes)
                value = loss(audio, text, leaves["logit_scale_a"], prec)
                got = torch.autograd.grad(value, [leaves[k] for k in keys]
                                          + [inner[s][1] for s in SIDES], allow_unused=True)
            if resolve is None or slopes is not None:
                break
            slopes = resolve(t - 1, {s: inner[s][0].detach() for s in SIDES},
                             dict(zip(SIDES, got[len(keys):])))
            if slopes is None:
                break
        grads = {k: torch.zeros_like(params[k]) if g is None else g.detach()
                 for k, g in zip(keys, got)}
        lr = lr_at(start_step + t - 1, opt)
        for k, p in params.items():
            g = grads[k]
            if p.ndim >= 2:
                p = p * (1.0 - lr * opt["weight_decay"])
            m[k] = b1 * m[k] + (1 - b1) * g
            v2[k] = b2 * v2[k] + (1 - b2) * g * g
            p = p - lr * (m[k] / (1 - b1 ** t)) / (torch.sqrt(v2[k] / (1 - b2 ** t)) + opt["eps"])
            params[k] = p
        for k in ("logit_scale_a", "logit_scale_t"):
            params[k] = params[k].clamp(max=MAX_LOGIT_SCALE)
        out["losses"].append(float(value.detach()))
        out["grads"].append(grads)
    out["params"] = params
    return out
