"""The port's contrastive train step held against the JAX package's on the
CPU: three steps of ``make_train_step`` from the same parameters (carried
across by ``load_jax_params``) on the same batch with no randomness
(``rng=None`` / no generator), for AdamW, Adam, SGD and the split optimizer,
with the decay mask, ``freeze_text``, mixup, the 4-term κ-weighted loss, the
logit-scale clamp and bn0's running statistics (one block a layer: the K4
route and the drop-path route); ``remat`` against the plain step;
``cosine_lr`` against JAX's.

Tolerances: the loss ``rtol=5e-5``; ``grad_norm`` ``rtol=1e-4``; every
parameter and buffer after three steps ``atol=2e-5, rtol=1e-4`` (the same
f32 program, sums in another order, through three updates at a rate of
1e-4); the optimizers alone on the same gradients ``rtol=1e-5, atol=1e-7``;
``remat`` exactly; ``cosine_lr`` ``rtol=1e-6, atol=1e-7 * base_lr`` (JAX
computes it in f32).
"""

import jax
import optax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.training import scheduler as j_sched
from audio_residual_tpu.training import train_clap as j_tc
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models.convert import clap_state_dict, load_jax_params
from audio_residual_tpu_torch.training import scheduler as t_sched
from audio_residual_tpu_torch.training import train_clap as t_tc

from . import torch_port_fixture as fx

B = 4
STEPS = 3
PARAMS = dict(atol=2e-5, rtol=1e-4)
# eps=1e-3: Adam's update is a continuous function of the gradient where the
# gradient is at rounding level (at eps=1e-8 an element whose true gradient
# is 0, a key bias, takes +-lr from either framework's rounding noise);
# test_adam_update_matches_optax_on_the_same_gradients holds the default eps
OPT = dict(lr=1e-4, warmup=2, total_steps=10, eps=1e-3)

# each case is one jit compile of the JAX step, so the options share cases
CASES = {
    # a logit scale above ln(100): the first step's clamp shows
    "adamw_mixup": dict(opt=dict(name="adamw", weight_decay=0.1), logit_scale=5.0,
                        step=dict(mixup_alpha=0.5)),
    "adam_freeze_text": dict(opt=dict(name="adam", weight_decay=0.1),
                             step=dict(freeze_text=True)),
    "sgd_mlp_kappa": dict(opt=dict(name="sgd", momentum=0.9),
                          step=dict(mlp_loss=True, weight_loss_kappa=2.0)),
    "split": dict(split=True),
}


def _configs():
    """The CLAP fixture's configs at one block a layer: block 0 takes K4's
    route (rate 0), block 1 the drop-path route (rate 0.1)."""
    import dataclasses

    jcfg = fx.jax_clap_config("roberta")
    tcfg = fx.port_clap_config("roberta")
    return (dataclasses.replace(jcfg, audio=dataclasses.replace(jcfg.audio, depths=(1, 1))),
            dataclasses.replace(tcfg, audio=dataclasses.replace(tcfg.audio, depths=(1, 1))))


def _params(seed: int = 0, logit_scale: float | None = None) -> dict:
    jcfg, _ = _configs()
    params = jax.tree.map(np.asarray, j_clap.init_clap_params(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    bn0 = params["audio_branch"]["bn0"]
    bn0["mean"] = r.standard_normal(bn0["mean"].shape).astype(np.float32)
    bn0["var"] = r.uniform(0.5, 2.0, bn0["var"].shape).astype(np.float32)
    if logit_scale is not None:
        params["logit_scale_a"] = np.float32(logit_scale)
    return params


def _batch(seed: int = 1) -> dict[str, np.ndarray]:
    r = np.random.default_rng(seed)
    text = fx.text_inputs("roberta", batch=B, seed=seed)
    return {"waveform": (0.1 * r.standard_normal((B, fx.AUDIO_KW["clip_samples"]))
                         ).astype(np.float32),
            "input_ids": text["input_ids"], "attention_mask": text["attention_mask"],
            "mixup_lambda": r.beta(0.5, 0.5, B).astype(np.float32)}


def _port_model(params):
    _, tcfg = _configs()
    return load_jax_params(t_clap.build_clap(tcfg, device="cpu"), params)


def _run_jax(params, batch, case):
    jcfg, _ = _configs()
    if case.get("split"):
        opt = j_tc.make_split_optimizer(lr_pretrained=1e-5, lr_new=1e-4, warmup=2,
                                        total_steps=10, weight_decay_pretrained=0.05,
                                        eps=1e-3)
    else:
        opt = j_tc.make_optimizer(**OPT, **case["opt"])
    state = j_tc.init_train_state(jax.tree.map(jnp.asarray, params), opt)
    step = j_tc.make_train_step(jcfg, opt, **case.get("step", {}))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jb, None)
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state["params"]), metrics


def _run_port(params, batch, case, **step_kw):
    model = _port_model(params)
    if case.get("split"):
        opt = t_tc.make_split_optimizer(model, lr_pretrained=1e-5, lr_new=1e-4, warmup=2,
                                        total_steps=10, weight_decay_pretrained=0.05,
                                        eps=1e-3)
    else:
        opt = t_tc.make_optimizer(model, **OPT, **case["opt"])
    state = t_tc.init_train_state(model, opt)
    step = t_tc.make_train_step(model, opt, **case.get("step", {}), **step_kw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
    return model, metrics


@pytest.fixture(scope="module")
def params():
    return _params()


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_jax(batch, name):
    case = CASES[name]
    params = _params(logit_scale=case.get("logit_scale"))
    j_params, j_metrics = _run_jax(params, batch, case)
    model, t_metrics = _run_port(params, batch, case)
    for jm, tm in zip(j_metrics, t_metrics):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=5e-5)
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(tm["logit_scale_a"], jm["logit_scale_a"], rtol=1e-6)
    if "logit_scale" in case:
        assert t_metrics[0]["logit_scale_a"] == pytest.approx(t_tc.MAX_LOGIT_SCALE)
    freeze = case.get("step", {}).get("freeze_text", False)
    ref = clap_state_dict(j_params, "roberta")
    got = model.state_dict()
    assert set(ref) == set(got)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, err_msg=k, **PARAMS)
    before = clap_state_dict(params, "roberta")
    moved = [k for k in before if not np.array_equal(before[k], got[k].detach().numpy())]
    assert "audio_branch.bn0.running_mean" in moved and "audio_branch.bn0.running_var" in moved
    text_moved = [k for k in moved if k.startswith("text_branch.")]
    if freeze:
        # only a decay could move a frozen text tower (adam has none)
        assert not text_moved
    else:
        assert any(before[k].ndim < 2 for k in text_moved)


class _Leaves(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))


@pytest.mark.parametrize("name,kw", [("adamw", dict(weight_decay=0.1)),
                                     ("adam", dict(weight_decay=0.1)),
                                     ("sgd", dict(momentum=0.9))])
def test_adam_update_matches_optax_on_the_same_gradients(name, kw):
    """The optimizers alone, at their default eps, fed the same gradients
    for three steps: a matrix (decayed), a vector and a scalar (not)."""
    r = np.random.default_rng(0)
    tree = {"w": r.standard_normal((6, 5)).astype(np.float32),
            "b": r.standard_normal(5).astype(np.float32), "s": np.float32(r.standard_normal())}
    tree["s"] = np.asarray(tree["s"])
    grads = [{k: np.asarray(r.standard_normal(np.shape(v)) * 10.0 ** r.integers(-6, 1),
                            np.float32) for k, v in tree.items()} for _ in range(3)]
    j_opt = j_tc.make_optimizer(lr=1e-2, warmup=2, total_steps=6, name=name, **kw)
    jp = jax.tree.map(jnp.asarray, tree)
    j_state = j_opt.init(jp)
    module = _Leaves(tree)
    t_opt = t_tc.make_optimizer(module, lr=1e-2, warmup=2, total_steps=6, name=name, **kw)
    for i, g in enumerate(grads):
        upd, j_state = j_opt.update(jax.tree.map(jnp.asarray, g), j_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        t_tc.set_lrs(t_opt, i)
        t_opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_decay_mask_matches_jax_by_dimension(params):
    """The port's decay mask and the JAX package's agree parameter by
    parameter (through the reference names)."""
    model = _port_model(params)
    mask = t_tc.decay_mask(model)
    sd = clap_state_dict(params, "roberta")
    for name, decays in mask.items():
        assert decays == (np.ndim(sd[name]) >= 2), name
    groups = t_tc.make_optimizer(model, weight_decay=0.2).param_groups
    assert [g["label"] for g in groups] == ["all/decay", "all/no_decay"]
    assert [g["weight_decay"] for g in groups] == [0.2, 0.0]
    assert t_tc.make_optimizer(model, weight_decay=0.2, name="adam").param_groups[0][
        "weight_decay"] == 0.0
    with pytest.raises(ValueError, match="optimizer name"):
        t_tc.make_optimizer(model, name="lion")


def test_split_optimizer_groups_label_the_towers(params):
    model = _port_model(params)
    opt = t_tc.make_split_optimizer(model, lr_pretrained=0.0, lr_new=1e-2)
    by_label = {g["label"]: {id(p) for p in g["params"]} for g in opt.param_groups}
    named = dict(model.named_parameters())
    pre = by_label["pretrained/decay"] | by_label["pretrained/no_decay"]
    for n, p in named.items():
        assert (id(p) in pre) == n.startswith(("audio_branch.", "text_branch.")), n


def test_remat_step_equals_plain_step(params, batch):
    """``remat=True`` recomputes the towers in the backward (with the same
    draws: a generator is given) and takes the same step, bit for bit."""
    case = {"opt": dict(name="adamw", weight_decay=0.1)}
    outs = []
    for remat in (False, True):
        model = _port_model(params)
        opt = t_tc.make_optimizer(model, **OPT, **case["opt"])
        state = t_tc.init_train_state(model, opt)
        step = t_tc.make_train_step(model, opt, remat=remat)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        _, m = step(state, tb, torch.Generator().manual_seed(5))
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        outs.append((m, grads, model.state_dict()))
    (m0, g0, s0), (m1, g1, s1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_generator_step_is_reproducible_and_random(params, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for seed in (0, 0, 1):
        model = _port_model(params)
        opt = t_tc.make_optimizer(model, **OPT)
        step = t_tc.make_train_step(model, opt)
        _, m = step(t_tc.init_train_state(model, opt), tb, torch.Generator().manual_seed(seed))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_loss_decreases_on_fixed_batch(params, batch):
    model = _port_model(params)
    opt = t_tc.make_optimizer(model, lr=3e-4, warmup=0, total_steps=1000)
    state = t_tc.init_train_state(model, opt)
    step = t_tc.make_train_step(model, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = [float(step(state, tb)[1]["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("base_lr,warmup,total", [(1e-3, 3, 10), (5e-4, 0, 7), (1e-4, 10, 10)])
def test_cosine_lr_matches_jax(base_lr, warmup, total):
    j, t = j_sched.cosine_lr(base_lr, warmup, total), t_sched.cosine_lr(base_lr, warmup, total)
    for s in range(total + 2):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, atol=1e-7 * base_lr)


def test_set_lrs_follows_each_groups_schedule(params):
    model = _port_model(params)
    opt = t_tc.make_split_optimizer(model, lr_pretrained=1e-4, lr_new=1e-3, warmup=2,
                                    total_steps=10)
    t_tc.set_lrs(opt, 0)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([5e-5, 5e-5, 5e-4, 5e-4])
    held = t_tc.make_optimizer(model, lr=1e-3, skip_scheduler=True)
    t_tc.set_lrs(held, 0)
    assert held.param_groups[0]["lr"] == 1e-3
