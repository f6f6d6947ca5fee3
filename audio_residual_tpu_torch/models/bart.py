"""BART encoder, the text tower of ``tmodel="bart"``.

Port of ``audio_residual_tpu/models/bart.py``: the encoder only (CLAP never
calls the decoder). Module attribute names give the HF ``BartModel`` keys
(``encoder.embed_tokens.weight``, ``encoder.embed_positions.weight``,
``encoder.layernorm_embedding``, ``encoder.layers.{i}.self_attn.q_proj``,
...). As in the JAX package: learned positions with HF's offset of 2, q
scaled by ``head_dim**-0.5`` before its product, the ``finfo.min`` additive
mask, post-LN blocks with exact-erf GELU. f32 only, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.models.roberta import init_normal_
from audio_residual_tpu_torch.ops.common import layer_norm

__all__ = ["BartConfig", "Bart", "bart_apply"]

POS_OFFSET = 2  # HF BartLearnedPositionalEmbedding hard-codes +2


@dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 50265
    d_model: int = 768
    num_layers: int = 6
    num_heads: int = 12
    ffn_dim: int = 3072
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


class _SelfAttn(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = _SelfAttn(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1, self.fc2 = nn.Linear(d, cfg.ffn_dim), nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: BartConfig):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings + POS_OFFSET, d)
        self.layernorm_embedding = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.num_layers))


class Bart(nn.Module):
    """``encoder.*``: the HF ``BartModel`` encoder layout. Random init from
    ``generator`` (the JAX package's scheme, N(0, 0.02))."""

    def __init__(self, cfg: BartConfig = BartConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        init_normal_(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))


def bart_apply(model: Bart, input_ids, attention_mask=None) -> dict:
    """Encoder forward -> ``{"encoder_last_hidden_state": [B, L, D]}``."""
    cfg, enc = model.cfg, model.encoder
    dev = enc.embed_tokens.weight.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).long()
    attention_mask = torch.as_tensor(attention_mask, device=dev)
    b, l = input_ids.shape
    d, nh = cfg.d_model, cfg.num_heads
    hd = d // nh
    eps = cfg.layer_norm_eps

    x = enc.embed_tokens.weight[input_ids]
    x = x + enc.embed_positions.weight[torch.arange(l, device=dev) + POS_OFFSET]
    x = layer_norm(x, enc.layernorm_embedding.weight, enc.layernorm_embedding.bias, eps)
    bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min

    def heads(t):
        return t.reshape(b, l, nh, hd).transpose(1, 2)

    for layer in enc.layers:
        a = layer.self_attn
        # HF BartAttention scales q by head_dim**-0.5 before the product
        q = heads(F.linear(x, a.q_proj.weight, a.q_proj.bias) * hd**-0.5)
        k = heads(F.linear(x, a.k_proj.weight, a.k_proj.bias))
        v = heads(F.linear(x, a.v_proj.weight, a.v_proj.bias))
        p = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        ctx = (p @ v).transpose(1, 2).reshape(b, l, d)
        ln1 = layer.self_attn_layer_norm
        x = layer_norm(x + F.linear(ctx, a.out_proj.weight, a.out_proj.bias), ln1.weight,
                       ln1.bias, eps)
        h = F.gelu(F.linear(x, layer.fc1.weight, layer.fc1.bias))
        ln2 = layer.final_layer_norm
        x = layer_norm(x + F.linear(h, layer.fc2.weight, layer.fc2.bias), ln2.weight, ln2.bias,
                       eps)
    return {"encoder_last_hidden_state": x}
