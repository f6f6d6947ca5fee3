"""Operations of one ResiDual λ-training step on cached images, as the
algorithm needs them (a multiply-add counts 2, elementwise work left out):

* the forward from the image: every stage of ``htsat_forward`` but the
  frontend, with the ResiDual at its layer;
* the backward to λ: the gradients of the activations (never of a frozen
  weight) through every product that lies after λ's first use, at the cost
  of one forward product each, and two for each attention product (scores
  and attend each give the gradients of both their operands); in a block
  whose attention input does not depend on λ (the ResiDual's first block)
  only the ResiDual's λ product and the FFNs after it; the TSCAM head, off
  the loss's path, gets no backward;
* Adam on the λ vector: negligible, not counted.
"""

from __future__ import annotations

from benchmark.counts.htsat_forward import block_ops, layer_shapes, stage_ops

__all__ = ["step_ops"]


def _backward_block(ops: dict, first: bool) -> int:
    """The backward of one block's products to its input (and λ)."""
    grad = ops["fc1"] + ops["fc2"]
    if "residual" in ops:
        # dλ needs (dY @ basisᵀ); the block input's gradient needs the
        # second product too, unless nothing before the ResiDual depends on λ
        grad += ops["residual"] // 2 if first else ops["residual"]
    if not first:
        grad += ops["qkv"] + ops["proj"] + 2 * (ops["scores"] + ops["attend"])
    return grad


def step_ops(cfg: dict, *, layer: int, k: int, classes: int = 50) -> int:
    a = cfg["audio"]
    fwd = stage_ops(cfg, residual={layer: k}, classes=classes)
    forward = sum(v for s, v in fwd.items() if s != "frontend")
    shapes = layer_shapes(a)
    backward = 0
    for i, s in enumerate(shapes):
        if i < layer:
            continue
        res = k if i == layer else None
        ops = block_ops(s["n"], s["c"], s["w2"], a["mlp_ratio"], res)
        for j in range(s["depth"]):
            backward += _backward_block(ops, first=(i == layer and j == 0))
        if i < len(shapes) - 1:
            backward += 2 * (s["n"] // 4) * (4 * s["c"]) * (2 * s["c"])
    last = shapes[-1]
    j = cfg["joint_embed_dim"]
    backward += 2 * (last["c"] * j + j * j) + 2 * j * classes
    return forward + backward
