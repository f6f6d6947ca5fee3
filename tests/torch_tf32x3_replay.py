"""The arithmetic of the port's golden routes replayed on the CPU: what the
3xTF32 GEMM (``csrc/gemm_sm90.cuh::gemm_tf32x3``) hands the tensor core and
how it sums, and the launch sequences of K2-K5 built on it
(``csrc/blocks.cuh``). Imports neither JAX nor the JAX package; the tests
hold these replays against the plain versions and the JAX kernels.

A product ``a @ W^T`` is replayed as the kernel runs it: ``a`` (less the
ResiDual mean, where the prologue subtracts it) split as the consumer splits
it, ``hi = rna(a)`` and ``lo = rna(a - hi)``; W's ``lo`` as stored, read as
TF32 (the tensor core reads the top 19 bits of an operand); per K step of 32
columns a partial sum, the two small terms first, added to an f32
accumulator.
"""

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.ops.common import attention_core, layer_norm
from audio_residual_tpu_torch.ops.cuda import tf32x3

H100_SMS = 132


def read_tf32(t: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (t.contiguous().view(torch.int32) & -(1 << 13)).view(torch.float32)


def tf32x3_matmul(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
                  a_sub: torch.Tensor | None = None) -> torch.Tensor:
    """``(a - a_sub) @ W^T`` as the kernels run it (module docstring)."""
    if a_sub is not None:
        a = a - a_sub
    a_hi, _ = tf32x3.split_tf32(a)
    a_lo, _ = tf32x3.split_tf32(a - a_hi)
    w_lo = read_tf32(w_lo)
    acc = torch.zeros(a.shape[0], w_hi.shape[0])
    for k0 in range(0, a.shape[1], 32):
        ah, al, wh, wl = (t[:, k0:k0 + 32] for t in (a_hi, a_lo, w_hi, w_lo))
        acc += (al @ wh.t() + ah @ wl.t()) + ah @ wh.t()
    return acc


def tf32x3_linear(a: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """``a @ w^T (+ bias)`` on the 3xTF32 GEMM, ``w`` split as the wrappers
    split it."""
    out = tf32x3_matmul(a, *tf32x3.split_tf32(w))
    return out if bias is None else out + bias


def attention_replay(y, wqkv, bqkv, wproj, bproj, bias, mask, nh) -> torch.Tensor:
    """K2's (and K5's) golden sequence on windows ``y [W, n, C]``: the qkv
    product, the f32 attention core, the proj product."""
    wn, n, c = y.shape
    qkv = tf32x3_linear(y.float().reshape(-1, c), wqkv, bqkv).reshape(wn, n, 3 * c)
    o = attention_core(qkv, bias, mask, nh=nh)
    return tf32x3_linear(o.reshape(-1, c), wproj, bproj).reshape(wn, n, c)


def residual_replay(a, basis, mean, lam) -> torch.Tensor:
    """The ResiDual's two products, ``((a - mean) @ basis^T * lam) @
    basis``, on what the wrappers hand the kernel
    (:func:`.tf32x3.residual_operands`: ``kr`` zero-padded to a multiple of
    8, the padded basis and its transpose split)."""
    r = tf32x3.residual_operands(basis, mean, lam, a.shape[0], H100_SMS)
    proj = tf32x3_matmul(a.float(), r.basis.hi, r.basis.lo, a_sub=r.mean) * r.lam
    return tf32x3_matmul(proj, r.basis_t.hi, r.basis_t.lo)


def ffn_replay(x, a, n2s, n2b, w1, b1, w2, b2, rp, double_ffn) -> torch.Tensor:
    """K3's golden route: [ResiDual] -> add + LN2 -> fc1 + GELU -> fc2 +
    residual [-> the second pass], every product in 3xTF32."""
    a = a.float()
    if rp is not None:
        a = residual_replay(a, rp["basis"], rp["mean"], rp["lam"])
    h1 = x.float() + a

    def ffn(t):
        hid = F.gelu(tf32x3_linear(layer_norm(t, n2s, n2b), w1, b1))
        return tf32x3_linear(hid, w2, b2)

    y = h1 + ffn(h1)
    if double_ffn:
        y2 = y + x.float()
        y = y2 + ffn(y2)
    return y


def block_replay(x, flat, rp, nh, bias, mask, double_ffn) -> torch.Tensor:
    """K4's golden route on windows ``x [W, n, C]``: LN1, K2's sequence,
    then K3's."""
    wn, n, c = x.shape
    y = layer_norm(x.float(), flat[0], flat[1])
    a = attention_replay(y, *flat[2:6], bias, mask, nh)
    out = ffn_replay(x.reshape(-1, c), a.reshape(-1, c), *flat[6:12], rp, double_ffn)
    return out.reshape(wn, n, c)


def layer_gemms(name: str) -> set:
    """``(product, N, K, tokens a clip)`` of every 3xTF32 product of every
    Swin layer of a registered HTSAT config: qkv, proj, fc1 and fc2, and the
    ResiDual's two (``res1`` ``[K = C] -> kr``, ``res2`` ``[kr] -> C``) at
    every component count from 1 to C, padded as the wrappers pad it."""
    cfg = factory._amodel_to_config(factory.get_model_config(name))
    res = cfg.spec_size // cfg.patch_stride[0]
    out = set()
    for i in range(len(cfg.depths)):
        c, tokens = cfg.embed_dim * 2 ** i, (res // 2 ** i) ** 2
        hidden = int(cfg.mlp_ratio * c)
        out |= {("qkv", 3 * c, c, tokens), ("proj", c, c, tokens),
                ("fc1", hidden, c, tokens), ("fc2", c, hidden, tokens)}
        for kr in {tf32x3.padded_components(k) for k in range(1, c + 1)}:
            out |= {("res1", kr, c, tokens), ("res2", c, kr, tokens)}
    return out
