"""CLIP causal transformer, the text tower of ``tmodel="transformer"``.

Port of ``audio_residual_tpu/models/clip_text.py``: token embedding plus a
learned positional embedding, pre-LN residual blocks under an upper-triangular
``-inf`` mask, exact or quick GELU, ``ln_final``, and the feature at the EOT
token (the row's largest id). f32, as in JAX.

Key layout. :class:`Transformer` holds ``resblocks.{i}.{ln_1,
attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}``. In a CLAP checkpoint it is ``text_branch`` and
``token_embedding``, ``positional_embedding`` and ``ln_final`` sit on the
model's root; in an OpenAI CLIP checkpoint it is ``transformer`` beside
them, the layout of :class:`ClipText`. :func:`clip_text_apply` takes the
blocks and the object that holds the other three.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.ops.common import layer_norm

__all__ = ["ClipTextConfig", "Transformer", "ClipText", "clip_text_apply", "resblocks_apply",
           "add_text_embeddings"]


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    context_length: int = 77
    quick_gelu: bool = False


class _Attention(nn.Module):
    """``nn.MultiheadAttention``'s parameter names."""

    def __init__(self, w: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * w, w))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * w))
        self.out_proj = nn.Linear(w, w)


class _Mlp(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.c_fc, self.c_proj = nn.Linear(w, 4 * w), nn.Linear(4 * w, w)


class _Block(nn.Module):
    def __init__(self, w: int):
        super().__init__()
        self.ln_1, self.attn = nn.LayerNorm(w), _Attention(w)
        self.ln_2, self.mlp = nn.LayerNorm(w), _Mlp(w)


class Transformer(nn.Module):
    """``resblocks.{i}`` at ``cfg.width`` and ``cfg.layers`` (a
    :class:`ClipTextConfig`, or the vision towers' config with an int
    ``layers``). Random init from ``generator``, the CLIP scheme of
    the JAX package (`model.py:551-560`): attention std ``w^-0.5``,
    projections ``w^-0.5 (2L)^-0.5``, ``c_fc`` ``(2w)^-0.5``, biases 0."""

    def __init__(self, cfg: ClipTextConfig, generator: torch.Generator):
        super().__init__()
        w = cfg.width
        self.resblocks = nn.ModuleList(_Block(w) for _ in range(cfg.layers))
        proj_std = w**-0.5 * (2 * cfg.layers) ** -0.5
        with torch.no_grad():
            for blk in self.resblocks:
                blk.attn.in_proj_weight.normal_(0.0, w**-0.5, generator=generator)
                blk.attn.out_proj.weight.normal_(0.0, proj_std, generator=generator)
                blk.mlp.c_fc.weight.normal_(0.0, (2 * w) ** -0.5, generator=generator)
                blk.mlp.c_proj.weight.normal_(0.0, proj_std, generator=generator)
                for lin in (blk.attn.out_proj, blk.mlp.c_fc, blk.mlp.c_proj):
                    lin.bias.zero_()


def add_text_embeddings(module: nn.Module, cfg: ClipTextConfig,
                        generator: torch.Generator) -> None:
    """Give ``module`` the tower's ``token_embedding`` (std 0.02),
    ``positional_embedding`` (std 0.01) and ``ln_final``."""
    module.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
    module.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
    module.ln_final = nn.LayerNorm(cfg.width)
    with torch.no_grad():
        module.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        module.positional_embedding.normal_(0.0, 0.01, generator=generator)


class ClipText(nn.Module):
    """The tower in the OpenAI CLIP layout: ``token_embedding``,
    ``positional_embedding``, ``transformer.resblocks.{i}``, ``ln_final``."""

    def __init__(self, cfg: ClipTextConfig = ClipTextConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        add_text_embeddings(self, cfg, gen)
        self.transformer = Transformer(cfg, gen)

    def forward(self, tokens) -> torch.Tensor:
        return clip_text_apply(self.transformer, self, tokens, self.cfg)


def clip_text_apply(transformer: Transformer, embeddings: nn.Module, tokens,
                    cfg: ClipTextConfig) -> torch.Tensor:
    """``tokens [B, L]`` -> the EOT token's features ``[B, width]``
    (`model.py:602-617`); ``embeddings`` holds ``token_embedding``,
    ``positional_embedding`` and ``ln_final``."""
    w = embeddings.token_embedding.weight
    tokens = torch.as_tensor(tokens, device=w.device).long()
    b, l = tokens.shape
    x = w[tokens] + embeddings.positional_embedding[:l]
    causal = torch.full((l, l), float("-inf"), dtype=x.dtype, device=x.device).triu(1)
    x = resblocks_apply(transformer, x, cfg.heads, cfg.quick_gelu, causal)
    x = layer_norm(x, embeddings.ln_final.weight, embeddings.ln_final.bias)
    return x[torch.arange(b, device=x.device), tokens.argmax(dim=-1)]


def resblocks_apply(transformer: Transformer, x: torch.Tensor, nh: int, quick_gelu: bool,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """The pre-LN residual blocks over ``x [B, L, width]`` with ``nh`` heads,
    the additive ``mask`` on the scores (the text tower's causal one; none
    in the vision towers), exact or quick GELU."""
    b, l, width = x.shape
    hd = width // nh

    def heads(t):
        return t.reshape(b, l, nh, hd).transpose(1, 2)

    for blk in transformer.resblocks:
        y = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
        qkv = F.linear(y, blk.attn.in_proj_weight, blk.attn.in_proj_bias)
        q, k, v = (heads(t) for t in qkv.chunk(3, dim=-1))
        s = (q / math.sqrt(hd)) @ k.transpose(-1, -2)
        p = torch.softmax(s if mask is None else s + mask, dim=-1)
        ctx = (p @ v).transpose(1, 2).reshape(b, l, width)
        x = x + F.linear(ctx, blk.attn.out_proj.weight, blk.attn.out_proj.bias)
        y = layer_norm(x, blk.ln_2.weight, blk.ln_2.bias)
        h = F.linear(y, blk.mlp.c_fc.weight, blk.mlp.c_fc.bias)
        h = h * torch.sigmoid(1.702 * h) if quick_gelu else F.gelu(h)
        x = x + F.linear(h, blk.mlp.c_proj.weight, blk.mlp.c_proj.bias)
    return x
