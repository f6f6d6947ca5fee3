"""RoBERTa / BERT encoder, the CLAP text tower (``tmodel="roberta"`` /
``"bert"``).

Port of ``audio_residual_tpu/models/roberta.py``. Module attribute names
give the HF ``state_dict`` keys (``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight``, ...,
``pooler.dense.weight``), the layout of the reference checkpoints'
``text_branch.``. CLAP takes ``pooler_output``.

Arithmetic, as in the JAX package: RoBERTa's padding-offset position ids
(BERT: 0-based), token type 0, the additive mask ``(1 - mask) *
finfo.min``, post-LN blocks with exact-erf GELU, ``tanh`` pooler on token
0.

Two modes. Golden (``compute_dtype=None``): plain f32 products (the JAX
package runs them outside any Pallas kernel, ``x @ kernel``). AMP
(``compute_dtype=torch.bfloat16``), the JAX contract
(``roberta.py:98-106,151-167``): every dense product takes bf16 operands
with f32 accumulation and gives f32; q/k and probabilities/v enter their
products rounded to bf16 with f32 accumulation; LayerNorm and softmax stay
f32. On the card the dense products run the port's bf16 TMA + ``wgmma``
GEMM (:func:`~audio_residual_tpu_torch.ops.cuda.gemm.gemm`) with the bias,
GELU and residual in its epilogue; the two 77x77 attention products a head
are f32 matmuls of the bf16-rounded operands (exact products, f32
accumulation).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.ops.common import layer_norm
from audio_residual_tpu_torch.ops.cuda.gemm import gemm
from audio_residual_tpu_torch.ops.cuda.window_attention import mxu_weights

__all__ = ["RobertaConfig", "Roberta", "roberta_apply", "position_ids_from_input_ids",
           "init_normal_"]


@dataclass(frozen=True)
class RobertaConfig:
    """Also covers BERT: ``style="bert"`` takes absolute 0-based position ids
    instead of RoBERTa's padding-offset ids. bert-base: vocab 30522, max_pos
    512, type_vocab 2, pad 0."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    style: str = "roberta"  # "roberta" | "bert"


def init_normal_(module: nn.Module, gen: torch.Generator, std: float = 0.02) -> None:
    """The JAX package's HF-style init: every weight matrix and embedding
    ``N(0, std)``, biases 0, LayerNorms identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=gen)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class _Dense(nn.Module):
    """HF's ``dense`` (+ ``LayerNorm``) holder."""

    def __init__(self, d_in: int, d_out: int, eps: float | None = None):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query, self.key, self.value = nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, d)


class _Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.self = _SelfAttention(cfg.hidden_size)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size, cfg.layer_norm_eps)


class _Layer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


class Roberta(nn.Module):
    """``embeddings``, ``encoder.layer.{i}``, ``pooler.dense``: the HF
    RoBERTa/BERT layout. Random init from ``generator`` (the JAX package's
    scheme, :func:`init_normal_`)."""

    def __init__(self, cfg: RobertaConfig = RobertaConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.style not in ("roberta", "bert"):
            raise ValueError(f"style must be 'roberta' or 'bert', got {cfg.style!r}")
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)
        init_normal_(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))


def position_ids_from_input_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa's padding-offset position ids: pad tokens get ``pad_token_id``,
    real tokens count up from ``pad_token_id + 1``."""
    mask = (input_ids != pad_token_id).long()
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


def bf16_round(t: torch.Tensor, dt) -> torch.Tensor:
    """``t`` rounded through ``dt`` and back to its own type (``dt=None``:
    ``t``): an operand of an exact product with f32 accumulation."""
    return t if dt is None else t.to(dt).to(t.dtype)


def _dense(lin: nn.Linear, x: torch.Tensor, dt, *, gelu: bool = False, residual=None,
           out_dtype=torch.float32) -> torch.Tensor:
    """``[gelu](x @ W^T + b) [+ residual]`` in f32. Under AMP bf16 operands
    on the bf16 GEMM (f32 accumulate; the bias, GELU and residual in its
    epilogue); ``out_dtype=bf16`` rounds the f32 result once, for a product
    whose only reader rounds it to bf16 anyway."""
    if dt is None:
        y = F.linear(x, lin.weight, lin.bias)
        if gelu:
            y = F.gelu(y)
        return y if residual is None else residual + y
    lead = x.shape[:-1]
    (w,) = mxu_weights(dt, lin.weight)
    a = x.reshape(-1, x.shape[-1]).to(dt).contiguous()
    r1 = None if residual is None else residual.reshape(-1, residual.shape[-1]).contiguous()
    return gemm(a, w, bias=lin.bias, gelu=gelu, r1=r1, out_dtype=out_dtype).reshape(*lead, -1)


def roberta_apply(model: Roberta, input_ids, attention_mask=None, *,
                  compute_dtype=None) -> dict:
    """``input_ids [B, L]`` (and ``attention_mask``, 1 = attend) ->
    ``{"last_hidden_state": [B, L, D], "pooler_output": [B, D]}`` in the
    model's float type. ``compute_dtype=torch.bfloat16`` is the AMP mode
    (module docstring)."""
    cfg, dt = model.cfg, compute_dtype
    if dt not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {dt}")
    emb = model.embeddings
    dev = emb.word_embeddings.weight.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).long()
    attention_mask = torch.as_tensor(attention_mask, device=dev)
    if cfg.style == "bert":
        pos_ids = torch.arange(input_ids.shape[-1], device=dev).expand_as(input_ids)
    else:
        pos_ids = position_ids_from_input_ids(input_ids, cfg.pad_token_id)
    x = (emb.word_embeddings.weight[input_ids] + emb.position_embeddings.weight[pos_ids]
         + emb.token_type_embeddings.weight[torch.zeros_like(input_ids)])
    eps = cfg.layer_norm_eps
    x = layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias, eps)
    # additive attention bias: 0 where attended, the dtype's lowest where masked
    bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min

    b, l, d = x.shape
    nh = cfg.num_heads
    hd = d // nh

    def heads(t):
        return t.reshape(b, l, nh, hd).transpose(1, 2)

    for layer in model.encoder.layer:
        sa, out = layer.attention.self, layer.attention.output
        xq = x if dt is None else x.to(dt)  # one cast for the three products
        q, k, v = (heads(_dense(lin, xq, dt)) for lin in (sa.query, sa.key, sa.value))
        s = bf16_round(q, dt) @ bf16_round(k, dt).transpose(-1, -2)
        p = torch.softmax(s / math.sqrt(hd) + bias, dim=-1)
        ctx = bf16_round(p, dt) @ bf16_round(v, dt)
        ctx = ctx.transpose(1, 2).reshape(b, l, d)
        x = _dense(out.dense, ctx, dt, residual=x)
        x = layer_norm(x, out.LayerNorm.weight, out.LayerNorm.bias, eps)
        h = _dense(layer.intermediate.dense, x, dt, gelu=True,
                   out_dtype=torch.float32 if dt is None else dt)
        fo = layer.output
        x = layer_norm(_dense(fo.dense, h, dt, residual=x), fo.LayerNorm.weight,
                       fo.LayerNorm.bias, eps)
    pooled = torch.tanh(_dense(model.pooler.dense, x[:, 0], dt))
    return {"last_hidden_state": x, "pooler_output": pooled}
