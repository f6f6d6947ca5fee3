"""Plain reference of the RoBERTa text tower (arXiv:1907.11692) as HF's
``RobertaModel`` trains it: embeddings (word, RoBERTa's padding-offset
positions, token type 0) and LayerNorm, post-LN encoder layers with
exact-erf GELU and bidirectional attention over the unpadded tokens, the
``tanh`` pooler on token 0. In training, dropout after the embeddings'
LayerNorm, on the attention probabilities, and on each attention output and
FFN output before its residual LayerNorm, with the keep masks given as
tensors (inverted dropout: a kept element scaled by ``1 / (1 - rate)``).

Written from the published description in plain PyTorch; it imports
nothing of the program. It takes a ``state_dict``-like mapping in HF's
layout under ``text_branch.`` (``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, ...,
``pooler.dense.weight``) and the ``text`` group of a benchmark
configuration, in HF's ``config.json`` names. Every product goes through
:func:`benchmark.reference.htsat.mm` at the given precision.

Departures from HF's model: the masked positions' additive bias is the
f32 minimum (HF's too), and the dropout masks come from the caller, not
from ``torch``'s own generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.htsat import Precision, layer_norm, linear, mm

__all__ = ["encode"]

P = "text_branch."


def _drop(x, keep, rate: float):
    return x if keep is None else x * keep / (1.0 - rate)


def encode(ids: torch.Tensor, attention_mask: torch.Tensor, w: dict, text: dict,
           dropout: dict | None, prec: Precision) -> torch.Tensor:
    """``ids``, ``attention_mask`` ``[B, L]`` -> the pooler output ``[B, D]``.
    ``dropout``: ``{"rate", "embed" [B, L, D], "layers": [(probs [B, heads,
    L, L], attention output [B, L, D], FFN output [B, L, D])]}`` keep masks,
    or None (no dropout)."""
    pad, eps = text["pad_token_id"], text["layer_norm_eps"]
    nh = text["num_attention_heads"]
    e = P + "embeddings."
    real = (ids != pad).long()
    pos = torch.cumsum(real, -1) * real + pad
    x = (w[e + "word_embeddings.weight"][ids] + w[e + "position_embeddings.weight"][pos]
         + w[e + "token_type_embeddings.weight"][torch.zeros_like(ids)])
    x = layer_norm(x, w[e + "LayerNorm.weight"], w[e + "LayerNorm.bias"], eps)
    rate = dropout["rate"] if dropout is not None else 0.0
    x = _drop(x, dropout["embed"] if dropout is not None else None, rate)
    bias = (1.0 - attention_mask[:, None, None, :].float()) * torch.finfo(torch.float32).min
    b, l, d = x.shape
    hd = d // nh

    def heads(t):
        return t.reshape(b, l, nh, hd).transpose(1, 2)

    for i in range(text["num_hidden_layers"]):
        p = f"{P}encoder.layer.{i}."
        keep = dropout["layers"][i] if dropout is not None else (None, None, None)
        q, k, v = (heads(linear(x, w[p + f"attention.self.{n}.weight"],
                                w[p + f"attention.self.{n}.bias"], prec))
                   for n in ("query", "key", "value"))
        probs = torch.softmax(mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd) + bias, -1)
        ctx = mm(_drop(probs, keep[0], rate), v, prec).transpose(1, 2).reshape(b, l, d)
        a = linear(ctx, w[p + "attention.output.dense.weight"],
                   w[p + "attention.output.dense.bias"], prec)
        x = layer_norm(x + _drop(a, keep[1], rate), w[p + "attention.output.LayerNorm.weight"],
                       w[p + "attention.output.LayerNorm.bias"], eps)
        h = F.gelu(linear(x, w[p + "intermediate.dense.weight"], w[p + "intermediate.dense.bias"],
                          prec))
        f = linear(h, w[p + "output.dense.weight"], w[p + "output.dense.bias"], prec)
        x = layer_norm(x + _drop(f, keep[2], rate), w[p + "output.LayerNorm.weight"],
                       w[p + "output.LayerNorm.bias"], eps)
    return torch.tanh(linear(x[:, 0], w[P + "pooler.dense.weight"], w[P + "pooler.dense.bias"],
                             prec))
