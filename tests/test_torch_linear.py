"""The 3xTF32 linear (``ops/cuda/linear.py``) on the CPU: its plain version
(every product a ``torch`` matmul in the kernel's decomposition -- the
transposed operands, the padding of M, the split of K) against ``F.linear``
and its autograd; the plans of its weight gradient; RoBERTa's routing
(``models/roberta.py::_dense``: ``F.linear`` on the CPU, the 3xTF32 linear
only for whole f32 weights on the card). The kernels themselves are held
against float64 by the card tests (``tests/test_torch_cuda.py``).

Tolerance: max |difference| / max |F.linear's| within 2e-6 (the same f32
products, summed in another order)."""

import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.models import roberta as t_roberta
from audio_residual_tpu_torch.ops.cuda import linear as L
from audio_residual_tpu_torch.ops.cuda import tf32x3

from .torch_threads import one_cpu_thread  # noqa: F401

TOL = 2e-6
# (m, n, k): RoBERTa's q/k/v/out, fc1 and fc2 at 32 texts of 77 tokens; one
# text of 77 (M padded to 80); N < K (dW^T, transposed back); ragged k-tiles
SHAPES = [(2464, 768, 768), (2464, 3072, 768), (2464, 768, 3072), (77, 64, 40),
          (1000, 40, 104), (96, 768, 768)]


def _rel(a, b) -> float:
    return float((a - b).detach().abs().max() / b.detach().abs().max())


@pytest.mark.parametrize("gelu,bias", [(False, True), (True, True), (False, False)],
                         ids=["bias", "bias-gelu", "no-bias"])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_linear_plain_version_matches_f_linear_autograd(m, n, k, gelu, bias):
    g = torch.Generator().manual_seed(m + n + k)
    x = torch.randn(m, k, generator=g, requires_grad=True)
    w = (torch.randn(n, k, generator=g) * k ** -0.5).requires_grad_()
    b = (torch.randn(n, generator=g) * 0.1).requires_grad_() if bias else None
    dy = torch.randn(m, n, generator=g)
    leaves = [x, w] + ([b] if bias else [])
    got = L.linear_tf32x3(x, w, b, gelu=gelu)
    want = L.linear_plain(x, w, b, gelu=gelu)
    assert got.shape == want.shape == (m, n)
    assert _rel(got, want) <= TOL
    for a, ref in zip(torch.autograd.grad(got, leaves, dy), torch.autograd.grad(want, leaves, dy)):
        assert a.shape == ref.shape and _rel(a, ref) <= TOL
    with torch.no_grad():  # without a graph: one product, GELU in the epilogue
        assert _rel(L.linear_tf32x3(x, w, b, gelu=gelu), want) <= TOL


def test_linear_keeps_the_leading_dimensions():
    x = torch.randn(3, 7, 16, requires_grad=True)
    w = torch.randn(24, 16, requires_grad=True)
    y = L.linear_tf32x3(x, w, None, gelu=True)
    assert y.shape == (3, 7, 24) and _rel(y, F.gelu(F.linear(x, w))) <= TOL
    (dx,) = torch.autograd.grad(y.sum(), [x])
    (ref,) = torch.autograd.grad(F.gelu(F.linear(x, w)).sum(), [x])
    assert dx.shape == x.shape and _rel(dx, ref) <= TOL


@pytest.mark.parametrize("m,n,k", SHAPES)
def test_weight_grad_plan_splits_the_smaller_operand_and_fills_the_card(m, n, k):
    p = L.weight_grad_plan(m, n, k)
    assert p.b_is_x == (k <= n)
    assert (p.rows, p.cols) == ((n, k) if p.b_is_x else (k, n))
    assert p.red % 4 == 0 and m <= p.red < m + 4
    k_tiles = math.ceil(p.red / tf32x3.K_STEP)
    per = math.ceil(k_tiles / p.splits)
    assert 1 <= p.splits <= L.MAX_SPLITS and (p.splits - 1) * per < k_tiles
    assert p.bn in tf32x3.GEMM_BNS and p.stages == tf32x3.ring(p.bn)[0]


@pytest.mark.parametrize("n,k", [(768, 768), (3072, 768), (768, 3072)])
def test_roberta_weight_gradients_use_every_sm(n, k):
    """At 96 texts of 77 tokens (M = 7392) RoBERTa's weight gradients, 36 to
    192 output tiles, split K until every one of the card's 132 SMs has a
    (split, tile) pair."""
    p = L.weight_grad_plan(96 * 77, n, k)
    tiles = math.ceil(p.rows / tf32x3.ROWS) * math.ceil(p.cols / p.bn)
    assert p.splits > 1 and tiles * p.splits >= 132


@pytest.mark.parametrize("n,k", [(768, 768), (3072, 768), (768, 3072)])
def test_products_take_the_widest_tile_at_robertas_shapes(n, k):
    """At M = 7392 the forward's and dx's products take 128-column tiles
    (the fastest on the card, tools/time_linear.py --sweep): the plan prices
    each k-step's fixed cost (the A fragment's load and split), without
    which the 32-column tile's fewer ragged waves would win."""
    assert tf32x3.gemm_plan(96 * 77, n, k, 132).bn == 128
    tiles = {bn: math.ceil(96 * 77 / tf32x3.ROWS) * math.ceil(n / bn) for bn in (32, 128)}
    assert math.ceil(tiles[32] / 132) * 32 < math.ceil(tiles[128] / 132) * 128


@pytest.mark.parametrize("r,c,ld", [(77, 40, 80), (8, 16, 8), (33, 24, 36)])
def test_split_t_is_the_split_of_the_padded_transpose(r, c, ld):
    t = torch.from_numpy(np.random.default_rng(r).standard_normal((r, c)).astype(np.float32))
    hi, lo = L.split_t(t, ld)
    assert hi.shape == lo.shape == (c, ld)
    assert torch.equal(hi + lo, F.pad(t.t(), (0, ld - r)))
    assert torch.equal(hi[:, r:], torch.zeros(c, ld - r)) and torch.equal(lo[:, r:], hi[:, r:])
    ref_hi, ref_lo = tf32x3.split_tf32(t.t().contiguous())
    assert torch.equal(hi[:, :r], ref_hi) and torch.equal(lo[:, :r], ref_lo)


@pytest.mark.parametrize("gelu,residual", [(False, False), (True, False), (False, True)],
                         ids=["plain", "gelu", "residual"])
def test_roberta_golden_dense_on_the_cpu_is_f_linear(gelu, residual):
    lin = torch.nn.Linear(32, 48)
    x = torch.randn(2, 5, 32)
    r = torch.randn(2, 5, 48) if residual else None
    got = t_roberta._dense(lin, x, None, gelu=gelu, residual=r)
    want = F.linear(x, lin.weight, lin.bias)
    want = F.gelu(want) if gelu else want
    assert torch.equal(got, want if r is None else r + want)


def test_the_3xtf32_route_takes_only_whole_f32_weights_on_the_card():
    card = types.SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.float32)
    w = torch.zeros(768, 3072)
    assert L.takes(card, w)
    assert not L.takes(torch.zeros(2, 3072), w)  # a CPU tensor
    assert not L.takes(types.SimpleNamespace(device=card.device, dtype=torch.float64), w)
    assert not L.takes(card, w.double())
    assert not L.takes(card, torch.zeros(100, 3072))  # N = 100: no multiple of 8
    assert not L.takes(card, torch.zeros(768, 36))    # K = 36


@pytest.mark.parametrize("dropout", [False, True], ids=["eval-masks", "dropout"])
def test_roberta_golden_route_fuses_qkv_with_the_same_result(dropout):
    """Where the 3xTF32 route takes the products (here forced on the CPU,
    whose linear runs the plain decomposition), q, k and v are one call on
    the concatenated weights: 4 calls a layer and the pooler's, with a
    graph and without; in training the pooled output and every
    parameter's gradient equal the ``F.linear`` route's within 1e-5 of each
    tensor's largest value (a gradient that is 0 but for rounding, the key
    bias's, against 1e-3 of the largest gradient)."""
    from unittest import mock

    cfg = t_roberta.RobertaConfig(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                                  intermediate_size=64, max_position_embeddings=20)
    model = t_roberta.Roberta(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # biases away from the init's zeros
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.02)
    ids = torch.randint(3, cfg.vocab_size, (3, 9), generator=torch.Generator().manual_seed(1))
    ids[0, 6:] = cfg.pad_token_id
    masks = (t_roberta.sample_dropout(torch.Generator().manual_seed(2), cfg, 3, 9)
             if dropout else None)
    params = list(model.parameters())
    calls = []

    def counted(*a, **k):
        calls.append(a[1].shape[0])
        return L.linear_tf32x3(*a, **k)

    def step(route: bool):
        with mock.patch.object(t_roberta, "takes", lambda x, w: route), \
                mock.patch.object(t_roberta, "linear_tf32x3", counted):
            out = t_roberta.roberta_apply(model, ids, dropout=masks)["pooler_output"]
            return out, torch.autograd.grad(out.square().sum(), params)

    got, got_grads = step(True)
    assert len(calls) == 4 * cfg.num_layers + 1 and calls.count(3 * cfg.hidden_size) == 2
    ref, ref_grads = step(False)
    assert _rel(got, ref) <= 1e-5
    top = max(float(r.abs().max()) for r in ref_grads)
    for g, r in zip(got_grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-3 * top)
    calls.clear()
    with torch.no_grad(), mock.patch.object(t_roberta, "takes", lambda x, w: True), \
            mock.patch.object(t_roberta, "linear_tf32x3", counted):
        assert _rel(t_roberta.roberta_apply(model, ids)["pooler_output"],
                    t_roberta.roberta_apply(model, ids, dropout=None)["pooler_output"]) == 0
    assert len(calls) == 2 * (4 * cfg.num_layers + 1)
