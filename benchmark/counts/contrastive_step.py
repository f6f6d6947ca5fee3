"""Operations of one contrastive training step of the whole CLAP model on
one rank, as the algorithm needs them (a multiply-add counts 2, elementwise
work left out: norms, GELU, softmax, dropout, drop-path, SpecAugment, AdamW):

* the audio forward (:mod:`benchmark.counts.htsat_forward`: the frontend
  at every DFT bin, the Swin layers with their patch merging, the TSCAM
  head, the projection);
* its backward: the gradients of both operands of every product after the
  frontend, at the cost of one forward product each (two for a weight
  product, two for the attention's scores and attend), but the patch
  embedding's (its input needs none: one) and the TSCAM head's (off the
  loss: none); nothing through the frontend, whose input is data;
* the text forward (:mod:`benchmark.counts.roberta_forward`) and its
  backward, twice its products (the embedding tables take gathered rows,
  no product);
* the two MLP transforms' forward (computed, off the two-term loss);
* the loss's ``B x B`` similarities and their backward.
"""

from __future__ import annotations

from benchmark.counts.htsat_forward import layer_shapes, stage_ops
from benchmark.counts.roberta_forward import span_ops

__all__ = ["audio_ops", "step_ops"]


def audio_ops(cfg: dict) -> dict:
    """``{"forward", "backward"}`` operations of one clip."""
    a = cfg["audio"]
    st = stage_ops(cfg, classes=0)
    last = layer_shapes(a)[-1]
    j = cfg["joint_embed_dim"]
    tscam = 2 * last["n"] * last["c"] * a["num_classes"] * 3
    projection = st["head"] - tscam
    g = a["spec_size"] // a["patch_size"]
    patch = 2 * g * g * a["embed_dim"] * a["patch_size"] ** 2
    layers = sum(v for k, v in st.items() if k.startswith("layer"))
    assert projection == 2 * (last["c"] * j + j * j)
    return {"forward": sum(st.values()),
            "backward": 2 * (layers - patch) + patch + 2 * projection}


def step_ops(cfg: dict, batch: int, context: int) -> int:
    audio = audio_ops(cfg)
    j = cfg["joint_embed_dim"]
    text = span_ops(cfg, batch, context)
    transforms = 2 * (2 * batch * 2 * j * j)
    similarities = 2 * batch * batch * j
    return (batch * (audio["forward"] + audio["backward"]) + 3 * text + transforms
            + 3 * similarities)
