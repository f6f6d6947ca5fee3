"""The port's FSDP (``parallel/fsdp.py``) on the CPU: the sharding rule
against the JAX package's ``fsdp_spec``; ``make_train_step`` over FSDP in 2
gloo processes against the single-process step, its gathered optimizer
state in the single-process layout; the big leaves and their
Adam moments on the rule's shards, the replicated leaves equal on both
ranks; and a kernel wrapper's refusal of a sharded tensor.

Tolerances: against one process, as ``tests/test_torch_distributed.py``'s
DDP step, ``atol=2e-5, rtol=1e-4`` on every parameter and buffer and
``rtol=1e-5`` on the losses (the same f32 program, the batch's sums split
over two ranks), ``rtol=1e-5`` on the gradient norm.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard, distribute_tensor

from audio_residual_tpu.parallel import fsdp as j_fsdp
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.ops.cuda import build
from audio_residual_tpu_torch.parallel import fsdp as t_fsdp
from audio_residual_tpu_torch.training import train_clap as t_tc

from . import torch_dist_workers as dw
from . import torch_port_fixture as fx

SPEC_CASES = [
    # tests/test_fsdp.py:46-60's shapes at n = 8
    ((128, 512), 8), ((512, 128), 8), ((256, 1024), 8), ((768,), 8), ((), 8), ((32, 96), 8),
    ((101, 333), 8), ((50265, 768), 8),
    # RoBERTa-base's word embedding at 2 ranks: 50265 is odd, so 768 shards
    ((50265, 768), 2), ((50265, 768), 1),
    ((64, 1, 4, 4), 2),  # a conv kernel under the floor
    ((127, 129), 2),  # over the floor, no dim divisible
    ((128, 127), 2),  # just under the floor (16256 elements)
    ((128, 128), 2),  # at the floor
    ((3, 8192), 4),  # the largest dim wins
    ((8192, 3, 8), 2),
    ((1024, 4096), 3),  # neither dim divisible by 3
]


@pytest.mark.parametrize("shape,n", SPEC_CASES, ids=[f"{s}-n{n}" for s, n in SPEC_CASES])
def test_fsdp_spec_is_the_jax_rule(shape, n):
    assert t_fsdp.fsdp_spec(shape, n) == tuple(j_fsdp.fsdp_spec(shape, n))
    assert (t_fsdp.fsdp_spec(shape, n, min_elems=64)
            == tuple(j_fsdp.fsdp_spec(shape, n, min_elems=64)))


STEPS = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return dw.run("fsdp_worker", 2, str(tmp_path_factory.mktemp("fsdp")), STEPS)


@pytest.fixture(scope="module")
def single():
    """The same steps in one process, without FSDP, on the whole batch."""
    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
    opt = t_tc.make_optimizer(model, lr=1e-4, warmup=1, total_steps=10, eps=1e-3,
                              weight_decay=0.1)
    state = t_tc.init_train_state(model, opt)
    step = t_tc.make_train_step(model, opt)
    batch = {k: torch.as_tensor(v) for k, v in dw.train_batch().items()}
    metrics = [step(state, batch)[1] for _ in range(STEPS)]
    return {"losses": [float(m["loss"]) for m in metrics],
            "grad_norms": [float(m["grad_norm"]) for m in metrics], "model": model,
            "optimizer": opt}


def test_fsdp_step_is_the_single_process_step(ranks, single):
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], single["grad_norms"], rtol=1e-5)
    got = ranks[0]["state_dict"]
    want = single["model"].state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-5, rtol=1e-4, err_msg=k)
    assert ranks[1]["state_dict"] == {}  # rank 0 alone keeps the gathered state


def test_fsdp_optimizer_state_is_the_single_process_one(ranks, single):
    """The gathered optimizer state has the unsharded optimizer's layout
    (its groups, split by placement under FSDP, merged back; the same ids)
    and each parameter's Adam moments within
    ``torch_dist_workers.assert_moments_close``'s bounds (the batch's sums
    split over two ranks move the last bits)."""
    got, want = ranks[0]["optimizer"], single["optimizer"].state_dict()
    assert got["param_groups"] == want["param_groups"]
    dw.assert_moments_close(got["state"], want["state"])
    assert ranks[1]["optimizer"] == {}


def test_big_leaves_and_their_moments_are_on_the_rules_shards(ranks, single):
    sharded = 0
    for name, p in single["model"].named_parameters():
        spec = t_fsdp.fsdp_spec(tuple(p.shape), 2)
        for r in ranks:
            if not spec:
                assert name in r["replicated"] and name not in r["shards"], name
                continue
            d = spec.index("data")
            local = tuple(s // 2 if i == d else s for i, s in enumerate(p.shape))
            want = ([str(Shard(d))], local)
            assert tuple(r["shards"][name]["param"]) == want, name
            assert [tuple(m) for m in r["shards"][name]["moments"]] == [want, want], name
        sharded += bool(spec)
    assert sharded >= 9  # the fixture's FFN weights and word embedding


def test_replicated_leaves_are_equal_on_both_ranks(ranks):
    a, b = (r["replicated"] for r in ranks)
    assert a.keys() == b.keys() and {"logit_scale_a", "logit_scale_t"} <= set(a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_kernel_wrappers_refuse_a_sharded_tensor(one_rank_group):
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(dist.group.WORLD, "cpu")
    w = distribute_tensor(torch.ones(8, 4), mesh, [Shard(0)])
    with pytest.raises(ValueError, match="DTensor"):
        build.check_cuda_inputs("fused_window_attention", {"x": torch.ones(2, 4), "wqkv": w})


def test_train_step_needs_a_sharded_model(one_rank_group):
    mesh = t_fsdp.fsdp_mesh("cpu")
    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
    opt = t_tc.make_optimizer(model)
    with pytest.raises(ValueError, match="shard_model"):
        t_tc.make_train_step(model, opt, fsdp_mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        t_tc.make_train_step(model, opt, mesh=mesh, fsdp_mesh=mesh)


@pytest.mark.parametrize("remat", [False, True])
def test_one_rank_fsdp_step_is_the_plain_step(one_rank_group, remat):
    """The path one card runs: FSDP over a group of one process, with and
    without the recomputed forward, against the step without FSDP."""
    batch = {k: torch.as_tensor(v) for k, v in dw.train_batch().items()}
    runs = []
    for sharded in (False, True):
        model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
        kw = {}
        if sharded:
            kw["fsdp_mesh"] = t_fsdp.fsdp_mesh("cpu")
            t_fsdp.shard_model(model, kw["fsdp_mesh"])
        opt = t_tc.make_optimizer(model, lr=1e-4, warmup=1, total_steps=10, eps=1e-3,
                                  weight_decay=0.1)
        state = t_tc.init_train_state(model, opt)
        step = t_tc.make_train_step(model, opt, remat=remat, **kw)
        losses = [float(step(state, batch, torch.Generator().manual_seed(i))[1]["loss"])
                  for i in range(STEPS)]
        sd = t_fsdp.full_state_dict(model)[0] if sharded else model.state_dict()
        runs.append((losses, sd))
    (want_losses, want), (got_losses, got) = runs
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-5, rtol=1e-4, err_msg=k)
