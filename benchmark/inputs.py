"""Inputs made from the run's seed, on the device, in a few large calls:
the weights in the reference LAION-CLAP ``state_dict`` layout, the clips,
the ResiDual's basis, the class-text embeddings and the labels. The program
and the reference get the same tensors; each kind draws from its own
stream, so a cell that uses fewer kinds sees the same values of the rest.
"""

from __future__ import annotations

import math

import torch

__all__ = ["generator", "state_dict_shapes", "weights", "clips", "residual", "text",
           "balanced_labels"]

STREAMS = {"weights": 1, "clips": 2, "residual": 3, "text": 4, "labels": 5}


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + STREAMS[stream]) % (2 ** 63))
    return g


def state_dict_shapes(cfg: dict) -> dict:
    """``{key: shape}`` of the audio tower and its projection, from the
    configuration alone."""
    a = cfg["audio"]
    e, p, mels = a["embed_dim"], a["patch_size"], a["mel_bins"]
    s = {"audio_branch.bn0." + k: (mels,) for k in ("weight", "bias", "running_mean",
                                                    "running_var")}
    s["audio_branch.patch_embed.proj.weight"] = (e, a["in_chans"], p, p)
    s["audio_branch.patch_embed.proj.bias"] = (e,)
    s["audio_branch.patch_embed.norm.weight"] = s["audio_branch.patch_embed.norm.bias"] = (e,)
    layers = len(a["depths"])
    for i, depth in enumerate(a["depths"]):
        c, nh = e << i, a["num_heads"][i]
        hidden = int(a["mlp_ratio"] * c)
        for j in range(depth):
            b = f"audio_branch.layers.{i}.blocks.{j}."
            s.update({b + "norm1.weight": (c,), b + "norm1.bias": (c,),
                      b + "attn.relative_position_bias_table": ((2 * a["window_size"] - 1) ** 2,
                                                                nh),
                      b + "attn.qkv.weight": (3 * c, c), b + "attn.qkv.bias": (3 * c,),
                      b + "attn.proj.weight": (c, c), b + "attn.proj.bias": (c,),
                      b + "norm2.weight": (c,), b + "norm2.bias": (c,),
                      b + "mlp.fc1.weight": (hidden, c), b + "mlp.fc1.bias": (hidden,),
                      b + "mlp.fc2.weight": (c, hidden), b + "mlp.fc2.bias": (c,)})
        if i < layers - 1:
            d = f"audio_branch.layers.{i}.downsample."
            s.update({d + "norm.weight": (4 * c,), d + "norm.bias": (4 * c,),
                      d + "reduction.weight": (2 * c, 4 * c)})
    c = e << (layers - 1)
    sf = a["spec_size"] // 2 ** (layers - 1) // a["patch_stride"][0] // (a["spec_size"]
                                                                         // mels)
    k = a["num_classes"]
    s.update({"audio_branch.norm.weight": (c,), "audio_branch.norm.bias": (c,),
              "audio_branch.tscam_conv.weight": (k, c, sf, 3),
              "audio_branch.tscam_conv.bias": (k,),
              "audio_branch.head.weight": (k, k), "audio_branch.head.bias": (k,)})
    j = cfg["joint_embed_dim"]
    s.update({"audio_projection.0.weight": (j, cfg["tower_width"]),
              "audio_projection.0.bias": (j,),
              "audio_projection.2.weight": (j, j), "audio_projection.2.bias": (j,)})
    return s


def weights(cfg: dict, seed: int, device) -> dict:
    """The tower's weights, f32, from one normal draw: matrices and kernels
    at ``1/sqrt(fan_in)``, the relative-position tables at 0.5, norm scales
    ``1 + 0.1 z`` and shifts ``0.1 z``, biases ``0.02 z``; ``bn0``'s running
    statistics near the log-mel of the traffic (mean -14 dB, variance
    100-140)."""
    shapes = state_dict_shapes(cfg)
    total = sum(math.prod(sh) for sh in shapes.values())
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if key.endswith("running_mean"):
            t = z - 14.0
        elif key.endswith("running_var"):
            t = 100.0 + 20.0 * z.abs()
        elif key.endswith("relative_position_bias_table"):
            t = 0.5 * z
        elif len(shape) >= 2:
            t = z * (1.0 / math.sqrt(math.prod(shape[1:])))
        elif ("norm" in key or "bn0" in key) and leaf == "weight":
            t = 1.0 + 0.1 * z
        elif "norm" in key or "bn0" in key:
            t = 0.1 * z
        else:
            t = 0.02 * z
        out[key] = t.contiguous()
    return out


def clips(seed: int, n: int, samples: int, gain_db: tuple, device) -> torch.Tensor:
    """``[n, samples]`` white noise, each clip at a gain drawn uniformly in
    ``gain_db`` (so the log-mel levels spread as a dataset's do; the loudest
    clips reach the int16 clamp)."""
    g = generator(seed, "clips", device)
    lo, hi = gain_db
    db = lo + (hi - lo) * torch.rand(n, 1, generator=g, device=device)
    return torch.randn(n, samples, generator=g, device=device) * 10.0 ** (db / 20.0)


def residual(seed: int, c: int, k: int, lam_std: float, mean_std: float, device) -> dict:
    """The ResiDual at one layer: an orthonormal basis ``[k, c]`` from a
    seeded QR, a small mean, and λ at ``1 + lam_std z``."""
    g = generator(seed, "residual", device)
    q, _ = torch.linalg.qr(torch.randn(c, c, generator=g, device=device, dtype=torch.float64))
    return {"basis": q.t()[:k].float().contiguous(),
            "mean": (mean_std * torch.randn(c, generator=g, device=device)).contiguous(),
            "lam": (1.0 + lam_std * torch.randn(k, generator=g, device=device)).contiguous()}


def text(seed: int, classes: int, dim: int, device) -> torch.Tensor:
    """``[classes, dim]`` unit class-text embeddings."""
    t = torch.randn(classes, dim, generator=generator(seed, "text", device), device=device)
    return t / t.norm(dim=-1, keepdim=True)


def balanced_labels(seed: int, n: int, classes: int, device) -> torch.Tensor:
    """``n`` labels, every class ``n // classes`` times, in a seeded order."""
    base = torch.arange(n, device=device) % classes
    perm = torch.randperm(n, generator=generator(seed, "labels", device), device=device)
    return base[perm]
