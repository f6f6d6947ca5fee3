"""The port's contrastive losses held against the JAX package on the CPU, and
their sharded form under ``torch.distributed`` (gloo, 2 processes) against
one process.

Tolerances: the loss against JAX ``rtol=1e-5`` (the same f32 formula, sums
in another order); the sharded loss against one process ``rtol=1e-5`` and
its DDP-averaged gradients ``rtol=1e-4, atol=1e-6``; the gather's gradient
exactly (sums of small integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.training import losses as j_losses
from audio_residual_tpu_torch.training import losses as t_losses

from . import torch_dist_workers as dw
from .torch_threads import one_cpu_thread  # noqa: F401

WORLD = 2


def _outputs(n=16, d=8, seed=0, scales=(10.0, 7.0)):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d)).astype(np.float32)
    t = rng.standard_normal((n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return {"audio_features": a, "text_features": t,
            "audio_features_mlp": (a * 0.3 + 0.1 * rng.standard_normal((n, d))).astype(np.float32),
            "text_features_mlp": (t * 0.3 + 0.1 * rng.standard_normal((n, d))).astype(np.float32),
            "logit_scale_a": np.float32(scales[0]), "logit_scale_t": np.float32(scales[1])}


@pytest.mark.parametrize("mlp_loss", [False, True])
@pytest.mark.parametrize("kappa", [0.0, 2.0])
@pytest.mark.parametrize("scales", [(10.0, 10.0), (10.0, 7.0)])
def test_clip_loss_matches_jax(mlp_loss, kappa, scales):
    """2-term and 4-term, with and without κ; unequal logit scales show the
    4-term loss's scale pairing."""
    out = _outputs(scales=scales)
    ref = float(j_losses.clip_loss({k: jnp.asarray(v) for k, v in out.items()},
                                   mlp_loss=mlp_loss, weight_loss_kappa=kappa))
    got = float(t_losses.clip_loss({k: torch.as_tensor(v) for k, v in out.items()},
                                   mlp_loss=mlp_loss, weight_loss_kappa=kappa))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_clip_loss_gradients_match_jax():
    import jax

    out = _outputs()
    keys = ("audio_features", "text_features", "audio_features_mlp", "text_features_mlp")

    def jloss(*feats):
        o = dict(zip(keys, feats), logit_scale_a=out["logit_scale_a"],
                 logit_scale_t=out["logit_scale_t"])
        return j_losses.clip_loss(o, mlp_loss=True)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(out[k]) for k in keys))
    feats = [torch.tensor(out[k], requires_grad=True) for k in keys]
    o = dict(zip(keys, feats), logit_scale_a=torch.tensor(out["logit_scale_a"]),
             logit_scale_t=torch.tensor(out["logit_scale_t"]))
    t_losses.clip_loss(o, mlp_loss=True).backward()
    for k, f, g in zip(keys, feats, jg):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_contrastive_weights_match_jax():
    f = _outputs()["audio_features"]
    np.testing.assert_allclose(t_losses.contrastive_weights(torch.from_numpy(f), 3.0).numpy(),
                               np.asarray(j_losses.contrastive_weights(jnp.asarray(f), 3.0)),
                               rtol=1e-6)


def test_gather_features_without_a_group_is_the_identity():
    out = {k: torch.as_tensor(v) for k, v in _outputs().items()}
    a, t = t_losses.gather_features(out["audio_features"], out["text_features"])
    assert a is out["audio_features"] and t is out["text_features"]
    assert len(t_losses.gather_features(a, t, a, t, mlp_loss=True)) == 4


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return dw.run("loss_worker", WORLD, str(tmp_path_factory.mktemp("loss")))


@pytest.mark.parametrize("mlp_loss,local_loss", dw.LOSS_CASES)
def test_sharded_loss_and_gradients_match_one_process(sharded, mlp_loss, local_loss):
    """Each rank feeds its rows through DDP; the loss is the global one on
    every rank (the local-loss variant's rank-offset labels give the same
    mean), and the averaged gradients are one process's on the whole
    batch."""
    model = dw.FeatureTowers()
    loss = t_losses.clip_loss(model(*dw.feature_inputs()), mlp_loss=mlp_loss)
    loss.backward()
    for rank in range(WORLD):
        got = sharded[rank][(mlp_loss, local_loss)]
        np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-5)
        for n, p in model.named_parameters():
            ref = p.grad if p.grad is not None else torch.zeros_like(p)
            np.testing.assert_allclose(got["grads"][n].numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {rank} {n}")


def test_gather_carries_gradient_to_every_shard(sharded):
    per = dw.feature_inputs()[0].shape[0] // WORLD
    for rank in range(WORLD):
        rows = torch.arange(rank * per, (rank + 1) * per, dtype=torch.float32)
        want = (WORLD * rows)[:, None].expand(per, dw.feature_inputs()[0].shape[1])
        assert torch.equal(sharded[rank]["gather_grad"], want)


def test_weighted_four_term_loss_refuses_several_ranks(sharded):
    assert all(r["kappa_raises"] for r in sharded)
