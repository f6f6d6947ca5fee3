"""K3's AMP route (``ffn_cluster_kernel``, ``csrc/ln_mlp.cu``) on the CPU:
its launch plan, and its decomposition of the function -- the hidden axis in
chunks of ``64 * CS`` columns, each rounded to bf16 and multiplied into an
f32 accumulator -- held against the plain version and the JAX kernel.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from audio_residual_tpu.ops.pallas import ln_mlp as j_k3
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.ops.common import layer_norm
from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
from audio_residual_tpu_torch.residual.module import residual_apply

from .torch_threads import one_cpu_thread  # noqa: F401

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
BF16 = torch.bfloat16
SMEM_LIMIT = 232448


def _k3_shapes(name: str) -> set:
    """``(C, hidden, tokens a clip)`` of every layer a registered HTSAT config
    runs through K3: a layer with one window per image (the split plan) or
    C >= 1024 (``fused_swin_block`` sends those to it)."""
    cfg = factory._amodel_to_config(factory.get_model_config(name))
    res = cfg.spec_size // cfg.patch_stride[0]
    shapes = set()
    for i in range(len(cfg.depths)):
        c, r = cfg.embed_dim * 2 ** i, res // 2 ** i
        if r <= cfg.window_size or c >= 1024:
            shapes.add((c, int(cfg.mlp_ratio * c), r * r))
    return shapes


SHIPPED = {(768, 3072, 64), (1024, 4096, 64), (1024, 4096, 256), (2048, 8192, 64)}


def test_shipped_configs_meet_only_the_planned_shapes():
    seen = set()
    for name in factory.list_models():
        if name.startswith("HTSAT"):
            seen |= _k3_shapes(name)
    assert seen == SHIPPED


@pytest.mark.parametrize("b", [1, 3, 32])
@pytest.mark.parametrize("c,hidden,tokens", sorted(SHIPPED))
def test_plan_of_every_shipped_shape(b, c, hidden, tokens):
    """Clusters of 6 at C = 768 (16 of them are resident at once on the H100,
    where only 15 of 8 are) and of 8 at C = 1024 and 2048: the accumulator
    [128, C/CS] fits a consumer thread's registers (at most 256 columns, 128
    registers), the chunk divides the hidden width, and shared memory holds
    the hid chunk and a ring of at least 3 stages."""
    rows = b * tokens
    plan = k3.amp_plan(rows, c, hidden)
    assert plan.cs == (6 if c == 768 else 8) and plan.n_out == c // plan.cs <= 256
    assert plan.chunk == 64 * plan.cs and hidden % plan.chunk == 0
    assert plan.stages >= 3 and plan.smem_bytes <= SMEM_LIMIT
    assert plan.grid == -(-rows // 128) * plan.cs


def _tapped_k3_shapes(name: str) -> set:
    """``(C, hidden, tokens a clip)`` of every layer of a registered HTSAT
    config: under taps every block runs the split plan, so K3 meets every
    layer (the K2 calls there are ``test_torch_window_plan.py``'s shipped
    window layers, which it plans)."""
    cfg = factory._amodel_to_config(factory.get_model_config(name))
    res = cfg.spec_size // cfg.patch_stride[0]
    return {(cfg.embed_dim * 2 ** i, int(cfg.mlp_ratio * cfg.embed_dim * 2 ** i),
             (res // 2 ** i) ** 2) for i in range(len(cfg.depths))}


TAPPED = {(96, 384, 4096), (192, 768, 1024), (384, 1536, 256), (768, 3072, 64),
          (128, 512, 4096), (256, 1024, 1024), (512, 2048, 256), (1024, 4096, 64),
          (256, 1024, 4096), (512, 2048, 1024), (1024, 4096, 256), (2048, 8192, 64)}


def test_shipped_configs_meet_only_the_tapped_shapes():
    seen = set()
    for name in factory.list_models():
        if name.startswith("HTSAT"):
            seen |= _tapped_k3_shapes(name)
    assert seen == TAPPED and SHIPPED <= TAPPED


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("c,hidden,tokens", sorted(TAPPED))
def test_plan_of_every_tapped_shape(b, c, hidden, tokens):
    """The tapped forward's K3 calls (every block of every layer, B*4096
    rows of 96 at HTSAT-tiny layer 0) plan: a block's output width is one the
    kernel is built for, the chunk divides the hidden width, and shared
    memory holds the hid chunk and a ring of at least 2 stages; the narrow
    layers take small clusters (C = 96: one block, 192: two, 128: two)."""
    rows = b * tokens
    plan = k3.amp_plan(rows, c, hidden)
    assert plan.n_out in k3.OUT_WIDTHS and plan.n_out * plan.cs == c
    assert plan.chunk == 64 * plan.cs and hidden % plan.chunk == 0
    assert plan.stages >= 2 and plan.smem_bytes <= SMEM_LIMIT
    assert plan.grid == -(-rows // 128) * plan.cs
    assert plan.cs == {96: 1, 192: 2, 384: 6, 768: 6, 128: 2, 256: 4, 512: 8, 1024: 8,
                       2048: 8}[c]


@pytest.mark.parametrize("rows,c,hidden,cs", [(512, 96, 384, 1), (128, 64, 256, 1),
                                              (192, 256, 1024, 4), (256, 128, 512, 2),
                                              (192, 384, 1536, 6)])
def test_plan_of_the_test_shapes(rows, c, hidden, cs):
    """The card tests' widths (C = 96, and C = 64 of the fixture config's
    AMP forward) take clusters of one, where the exchange is trivial."""
    plan = k3.amp_plan(rows, c, hidden)
    assert (plan.cs, plan.n_out) == (cs, c // cs)
    assert plan.smem_bytes <= SMEM_LIMIT and hidden % plan.chunk == 0


@pytest.mark.parametrize("rows,c,hidden,match", [
    (128, 32, 128, "no AMP plan"),        # C / CS is no width the kernel is built for
    (128, 100, 400, "no multiple of 8"),
    (128, 768, 3000, "no multiple of 64"),
    (128, 768, 3008, "no AMP plan"),      # hidden no multiple of 64 * CS for any CS
    (0, 768, 3072, "empty shape"),
    (128, 4096, 16384, "above 2048"),
])
def test_plan_refuses_other_shapes(rows, c, hidden, match):
    with pytest.raises(ValueError, match=match):
        k3.amp_plan(rows, c, hidden)


def _inputs(seed, rows, c, hidden):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    rp = {"basis": torch.from_numpy(q.astype(np.float32)), "mean": t(c, scale=0.01),
          "lam": t(c, scale=0.1, offset=1.0)}
    weights = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(hidden, c, scale=c ** -0.5),
               t(hidden, scale=0.02), t(c, hidden, scale=hidden ** -0.5), t(c, scale=0.02))
    return t(rows, c, scale=0.5), t(rows, c, scale=0.1), weights, rp


def _bf16(t):
    return t.to(BF16).float()


def _pass_replay(h, n2s, n2b, w1, b1, w2, b2, chunk, r2=None):
    """One pass of the kernel in its order: z = bf16(LN2(h)); per chunk of
    hidden columns, bf16(GELU(z @ W1[chunk]^T + b1)) @ W2[:, chunk]^T into an
    f32 accumulator; then + b2 + h (+ r2)."""
    z = _bf16(layer_norm(h, n2s, n2b))
    acc = torch.zeros(h.shape[0], w2.shape[0])
    for t0 in range(0, w1.shape[0], chunk):
        hid = _bf16(F.gelu(z @ _bf16(w1[t0:t0 + chunk]).t() + b1[t0:t0 + chunk]))
        acc += hid @ _bf16(w2[:, t0:t0 + chunk]).t()
    out = acc + b2 + h
    return out if r2 is None else out + r2


def _kernel_replay(x, a, weights, rp, double_ffn):
    """The AMP entry's passes: [ResiDual] h, pass 1, [pass 2 from y2]."""
    plan = k3.amp_plan(x.shape[0], x.shape[1], weights[2].shape[0])
    av = a if rp is None else residual_apply(a, rp["basis"], rp["mean"], rp["lam"])
    h = x.float() + av.float()
    if not double_ffn:
        return _pass_replay(h, *weights, plan.chunk)
    y2 = _pass_replay(h, *weights, plan.chunk, r2=x.float())
    return _pass_replay(y2, *weights, plan.chunk)


def _assert_close(got, ref):
    """Within a quarter of a bf16 ulp of the largest output (2^-10 of it) at
    every element, and 5e-6 of it on the mean gap: the size of one bf16 hid
    value (or, in the double FFN's second pass, one z value) rounded the
    other way after a sum taken in another order, carried through fc2. On
    this CPU the single passes agree to 1e-6; the double FFN's second pass
    reaches 5e-4 of its largest output, and XLA's sums 8e-4."""
    got, ref = np.asarray(got, dtype=np.float32), np.asarray(ref, dtype=np.float32)
    scale = float(np.abs(ref).max())
    gap = np.abs(got - ref)
    assert float(gap.max()) <= scale / 1024, (float(gap.max()), scale)
    assert float(gap.mean()) <= 5e-6 * scale, (float(gap.mean()), scale)


VARIANTS = [(False, False), (True, False), (True, True)]
VARIANT_IDS = ["plain", "residual", "double-ffn"]


@pytest.mark.parametrize("use_res,dffn", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("rows,c,hidden", [(192, 768, 3072), (192, 256, 1024)])
def test_kernel_decomposition_matches_plain_amp(use_res, dffn, rows, c, hidden):
    """The chunked hidden axis is exact: GELU is element-wise and fc2 sums
    over hidden units, so only the summation order differs from the plain
    AMP version (limits: :func:`_assert_close`)."""
    x, a, weights, rp = _inputs(0, rows, c, hidden)
    rp = rp if use_res else None
    got = _kernel_replay(x, a, weights, rp, dffn)
    ref = k3.residual_ffn_plain(x, a, *weights, rp, double_ffn=dffn, mxu_dtype=BF16)
    assert got.shape == ref.shape and ref.dtype == torch.float32
    _assert_close(got, ref)


@pytest.mark.parametrize("use_res,dffn", VARIANTS, ids=VARIANT_IDS)
def test_amp_matches_jax_kernel(use_res, dffn):
    """Under AMP against the JAX ``fused_residual_ffn(mxu_dtype=bf16)`` (its
    Pallas kernel in interpret mode), which rounds z and the hidden
    activation to bf16 at the same places. Its GELU uses the
    Abramowitz-Stegun erf (error <= 1.5e-7) and XLA sums each product in
    another order, so a few bf16 values round the other way: the limits of
    :func:`_assert_close`, for the plain AMP version (the wrapper's CPU
    route) and the kernel's decomposition."""
    rows, c, hidden = 256, 128, 512
    x, a, weights, rp = _inputs(1, rows, c, hidden)
    rp = rp if use_res else None
    n2s, n2b, w1, b1, w2, b2 = weights
    jr = {k: jnp.asarray(v.numpy()) for k, v in rp.items()} if use_res else None
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k3.fused_residual_ffn(
            jnp.asarray(x.numpy()), jnp.asarray(a.numpy()), n2s.numpy(), n2b.numpy(),
            w1.t().numpy(), b1.numpy(), w2.t().numpy(), b2.numpy(), jr, double_ffn=dffn,
            mxu_dtype=jnp.bfloat16)).astype(np.float32)
    got = k3.fused_residual_ffn(x, a, *weights, rp, double_ffn=dffn, mxu_dtype=BF16)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    for out in (got, _kernel_replay(x, a, weights, rp, dffn)):
        _assert_close(out, ref)


def test_workspace_holds_what_the_entry_carves():
    """z bf16, then h1 and proj f32 with ResiDual, then y2 f32 with the
    double FFN, each 256-byte aligned (``arpu::Arena``)."""
    assert k3.amp_workspace_bytes(192, 768, 0, False) == 192 * 768 * 2
    assert k3.amp_workspace_bytes(100, 96, 96, True) == (
        19200 + 38400 + 38400 + 38400)
    assert k3.amp_workspace_bytes(1, 64, 3, False) == 256 + 256 + 256
