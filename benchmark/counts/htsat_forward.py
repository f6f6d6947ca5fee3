"""Operations and bytes of one clip through the zero-shot path, as the
algorithm needs them: a multiply-add counts 2; norms, GELU, softmax and
other elementwise work are left out (under 2% of the total).

Stages, in the order the benchmark's split-point spans take them:
``frontend`` (the DFT at every one of the ``n_fft // 2 + 1`` bins, the mel
product, the bicubic stretch of time as a dense product), ``layer{i}``
(layer 0 with the patch embedding; each layer with its patch merging),
``head`` (the TSCAM convolution, the audio projection and the similarities
against the class texts). A layer that carries the ResiDual runs its two
products and the patched block's second FFN pass.

Frozen from the program's ``utils/profiling.py::htsat_flops_per_clip``
with its implementation-dependent frontend term replaced by the full DFT
and the ResiDual's work added.
"""

from __future__ import annotations

__all__ = ["frames", "block_ops", "stage_ops", "forward_ops", "swin_bytes", "layer_shapes"]


def frames(a: dict) -> int:
    """Centred STFT frames of a padded clip."""
    n_fft, hop = a["n_fft"], a["hop_size"]
    return (a["clip_samples"] + 2 * (n_fft // 2) - n_fft) // hop + 1


def layer_shapes(a: dict) -> list[dict]:
    """Per layer: tokens ``n``, width ``c``, heads, window tokens ``w2``,
    blocks."""
    g = a["spec_size"] // a["patch_size"]
    out = []
    for i, depth in enumerate(a["depths"]):
        res = g >> i
        w = min(a["window_size"], res)
        out.append(dict(n=res * res, c=a["embed_dim"] << i, heads=a["num_heads"][i],
                        w2=w * w, depth=depth, res=res))
    return out


def block_ops(n: int, c: int, w2: int, mlp_ratio: float, residual_k: int | None) -> dict:
    """One Swin block on ``n`` tokens: its products by name."""
    hidden = int(mlp_ratio * c)
    ffn_passes = 2 if residual_k else 1
    ops = {"qkv": 2 * n * c * 3 * c, "scores": 2 * n * w2 * c, "attend": 2 * n * w2 * c,
           "proj": 2 * n * c * c, "fc1": ffn_passes * 2 * n * c * hidden,
           "fc2": ffn_passes * 2 * n * hidden * c}
    if residual_k:
        ops["residual"] = 2 * (2 * n * c * residual_k)
    return ops


def stage_ops(cfg: dict, *, residual: dict | None = None, classes: int = 50) -> dict:
    """``{stage: operations}`` of one clip; ``residual`` maps a layer to its
    ResiDual's component count."""
    a = cfg["audio"]
    residual = residual or {}
    f = frames(a)
    bins = a["n_fft"] // 2 + 1
    mels = a["mel_bins"]
    stretched = a["spec_size"] * (a["spec_size"] // mels)
    out = {"frontend": f * 2 * (2 * a["n_fft"] * bins) + f * 2 * bins * mels
           + 2 * stretched * f * mels}
    shapes = layer_shapes(a)
    g = a["spec_size"] // a["patch_size"]
    patch = 2 * g * g * a["embed_dim"] * a["patch_size"] ** 2
    for i, s in enumerate(shapes):
        blk = sum(block_ops(s["n"], s["c"], s["w2"], a["mlp_ratio"], residual.get(i)).values())
        ops = s["depth"] * blk + (patch if i == 0 else 0)
        if i < len(shapes) - 1:
            ops += 2 * (s["n"] // 4) * (4 * s["c"]) * (2 * s["c"])
        out[f"layer{i}"] = ops
    last = shapes[-1]
    j = cfg["joint_embed_dim"]
    out["head"] = (2 * last["n"] * last["c"] * a["num_classes"] * 3
                   + 2 * (last["c"] * j + j * j) + 2 * j * classes)
    return out


def forward_ops(cfg: dict, **kw) -> int:
    return sum(stage_ops(cfg, **kw).values())


def swin_bytes(cfg: dict, batch: int, *, act_bytes: int, weight_bytes: int) -> int:
    """Bytes of the Swin layers' spans for one batch: each span reads its
    input once (the image for layer 0) and its weights once, and writes its
    output once; matrices at ``weight_bytes``, vectors in f32."""
    a = cfg["audio"]
    shapes = layer_shapes(a)
    total = batch * a["spec_size"] ** 2 * act_bytes  # the image into layer 0
    e = a["embed_dim"]
    total += a["patch_size"] ** 2 * e * weight_bytes + 3 * e * 4
    for i, s in enumerate(shapes):
        c, hidden = s["c"], int(a["mlp_ratio"] * s["c"])
        mats = 3 * c * c + c * c + 2 * c * hidden
        vecs = 3 * c + c + hidden + c + 4 * c + (2 * a["window_size"] - 1) ** 2 * s["heads"]
        total += s["depth"] * (mats * weight_bytes + vecs * 4)
        out_tokens, out_c = s["n"], c
        if i < len(shapes) - 1:
            total += 8 * c * c * weight_bytes + 8 * c * 4
            out_tokens, out_c = s["n"] // 4, 2 * c
        total += batch * out_tokens * out_c * act_bytes  # written
        if i < len(shapes) - 1:
            total += batch * out_tokens * out_c * act_bytes  # read by the next span
    return total
