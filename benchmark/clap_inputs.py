"""Inputs of the contrastive cells made from the run's seed, on the device:
the whole CLAP model's weights in the reference LAION-CLAP ``state_dict``
layout (the audio side as :func:`benchmark.inputs.weights` makes it, the
text side, the projections, the transforms and the logit scales from a
stream of their own) and the captions' token ids.
"""

from __future__ import annotations

import math

import torch

from benchmark import inputs

__all__ = ["text_shapes", "state_dict_shapes", "weights", "captions"]

TEXT_STREAM = 6  # after inputs.STREAMS' five
LOGIT_SCALE = math.log(1 / 0.07)  # LAION-CLAP's initial logit scales


def text_shapes(cfg: dict) -> dict:
    """``{key: shape}`` of the text tower (HF RoBERTa's layout under
    ``text_branch.``), its projection, the two MLP transforms and the logit
    scales."""
    t, j = cfg["text"], cfg["joint_embed_dim"]
    d, ff = t["hidden_size"], t["intermediate_size"]
    e = "text_branch.embeddings."
    s = {e + "word_embeddings.weight": (t["vocab_size"], d),
         e + "position_embeddings.weight": (t["max_position_embeddings"], d),
         e + "token_type_embeddings.weight": (t["type_vocab_size"], d),
         e + "LayerNorm.weight": (d,), e + "LayerNorm.bias": (d,)}
    for i in range(t["num_hidden_layers"]):
        p = f"text_branch.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            s[p + f"attention.self.{n}.weight"] = (d, d)
            s[p + f"attention.self.{n}.bias"] = (d,)
        s.update({p + "attention.output.dense.weight": (d, d),
                  p + "attention.output.dense.bias": (d,),
                  p + "attention.output.LayerNorm.weight": (d,),
                  p + "attention.output.LayerNorm.bias": (d,),
                  p + "intermediate.dense.weight": (ff, d), p + "intermediate.dense.bias": (ff,),
                  p + "output.dense.weight": (d, ff), p + "output.dense.bias": (d,),
                  p + "output.LayerNorm.weight": (d,), p + "output.LayerNorm.bias": (d,)})
    s.update({"text_branch.pooler.dense.weight": (d, d), "text_branch.pooler.dense.bias": (d,),
              "text_projection.0.weight": (j, d), "text_projection.0.bias": (j,),
              "text_projection.2.weight": (j, j), "text_projection.2.bias": (j,)})
    for side in ("audio", "text"):
        for n in (0, 3):
            s[f"{side}_transform.sequential.{n}.weight"] = (j, j)
            s[f"{side}_transform.sequential.{n}.bias"] = (j,)
    s["logit_scale_a"] = s["logit_scale_t"] = ()
    return s


def state_dict_shapes(cfg: dict) -> dict:
    """``{key: shape}`` of the whole model."""
    return {**inputs.state_dict_shapes(cfg), **text_shapes(cfg)}


def weights(cfg: dict, seed: int, device) -> dict:
    """The whole model's weights, f32: the audio side as
    :func:`benchmark.inputs.weights` draws it; the rest from one normal draw
    of its own stream with the same rules (matrices and embedding tables at
    ``1/sqrt(fan_in)``, norm scales ``1 + 0.1 z`` and shifts ``0.1 z``,
    biases ``0.02 z``); both logit scales at ``ln(1 / 0.07)``."""
    out = inputs.weights(cfg, seed, device)
    shapes = {k: v for k, v in text_shapes(cfg).items() if v}
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + TEXT_STREAM) % (2 ** 63))
    flat = torch.randn(sum(math.prod(sh) for sh in shapes.values()), generator=g, device=device)
    at = 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            t = z * (1.0 / math.sqrt(shape[-1]))
        elif "LayerNorm" in key and key.endswith("weight"):
            t = 1.0 + 0.1 * z
        elif "LayerNorm" in key:
            t = 0.1 * z
        else:
            t = 0.02 * z
        out[key] = t.contiguous()
    for key in ("logit_scale_a", "logit_scale_t"):
        out[key] = torch.tensor(LOGIT_SCALE, device=device)
    return out


def captions(seed: int, n: int, cfg: dict, traffic: dict, device) -> tuple:
    """``(input_ids, attention_mask)`` ``[n, context]``: ``<s>`` ids of a
    length uniform in ``traffic["tokens"]`` (both ends included, the two
    specials counted) drawn uniformly from ``traffic["id_range"]``, then
    ``</s>``, then padding."""
    t = cfg["text"]
    ctx = traffic["context"]
    lo, hi = traffic["tokens"]
    first, last = traffic["id_range"]
    g = inputs.generator(seed, "text", device)
    lengths = torch.randint(lo, hi + 1, (n, 1), generator=g, device=device)
    body = torch.randint(first, last + 1, (n, ctx), generator=g, device=device)
    pos = torch.arange(ctx, device=device)[None]
    ids = torch.where(pos < lengths - 1, body, t["pad_token_id"])
    ids = torch.where(pos == lengths - 1, traffic["eos_id"], ids)
    ids[:, 0] = traffic["bos_id"]
    return ids, (pos < lengths).long()
