"""Operations and bytes of the text side's forward under the port's span
``encode_text`` for one batch, as the algorithm needs them: RoBERTa's
products (a multiply-add counts 2; LayerNorm, GELU, softmax, dropout and
the embeddings' gathers left out) and the text projection.

Bytes: every weight the span reads, once, in f32 (the encoder, the pooler,
the projection, and the embedding rows the batch gathers); each layer reads
its input and writes its output once, in f32, as do the embeddings.
"""

from __future__ import annotations

__all__ = ["layer_ops", "span_ops", "span_bytes"]


def layer_ops(text: dict, batch: int, context: int) -> int:
    """One encoder layer on ``batch`` texts of ``context`` tokens: q, k, v
    and the attention output, scores and probabilities @ v over every
    position, the two FFN products."""
    d, ff = text["hidden_size"], text["intermediate_size"]
    tokens = batch * context
    return 2 * tokens * d * d * 4 + 2 * 2 * batch * context * context * d + 2 * 2 * tokens * d * ff


def span_ops(cfg: dict, batch: int, context: int) -> int:
    """The tower (every layer, the pooler on token 0) and the projection
    (Linear, ReLU, Linear to the joint width)."""
    t, j = cfg["text"], cfg["joint_embed_dim"]
    d = t["hidden_size"]
    return (t["num_hidden_layers"] * layer_ops(t, batch, context) + 2 * batch * d * d
            + 2 * batch * (d * j + j * j))


def span_bytes(cfg: dict, batch: int, context: int) -> int:
    t, j = cfg["text"], cfg["joint_embed_dim"]
    d, ff, nl = t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"]
    tokens = batch * context
    layer_weights = 4 * d * d + 2 * d * ff + 4 * d + ff + d + 2 * 2 * d  # and their LNs
    weights = (nl * layer_weights + d * d + d + d * j + j + j * j + j
               + 2 * tokens * d + d + 2 * d)  # the gathered rows, the type row, LN
    activations = (nl + 1) * 2 * tokens * d
    return 4 * (weights + activations)
