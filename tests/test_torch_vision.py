"""The port's CLIP vision side held against the JAX package on the CPU: the
ModifiedResNet, the ViT and the timm adapter's pool/projection pairs
(``models/vision.py``), ``clip_apply`` through the committed fixture
``tests/data/torch_port_vision.npz``, the freeze masks, the 10 vision
configs, the image transforms and ImageNet zero-shot.

Weights: the JAX pytree's leaf shapes (``jax.eval_shape`` of its init, no
weights built), values from a seed (``torch_port_fixture.seeded_tree_leaves``),
carried into the port by ``models/convert.py``. Tolerance: max abs error
<= 1e-5 * max |JAX output|. The timm trunks are narrowed in both packages'
registries (the same names), so no full-width trunk is built.
"""

import dataclasses
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from audio_residual_tpu.data import transforms as j_transforms
from audio_residual_tpu.evaluate import zero_shot_imagenet as j_zsi
from audio_residual_tpu.models import clip as j_clip
from audio_residual_tpu.models import factory as j_factory
from audio_residual_tpu.models import vision as j_vision
from audio_residual_tpu_torch.data import transforms as t_transforms
from audio_residual_tpu_torch.evaluate import zero_shot_imagenet as t_zsi
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import vision as t_vision
from audio_residual_tpu_torch.models.convert import clip_state_dict, load_jax_params, \
    vision_state_dict

from . import torch_port_fixture as fx

REL = 1e-5
NARROW_TRUNKS = {  # the registry's names, narrow widths
    "vit_base_patch32_224": ({"layers": 1, "width": 64, "patch_size": 8}, "vit", 64),
    "resnet50": ({"layers": (1, 1, 1, 1), "width": 8}, "resnet", 256),
}
VISION_CONFIGS = ["RN50", "RN50-quickgelu", "RN50x4", "RN50x16", "RN101", "RN101-quickgelu",
                  "ViT-B-16", "ViT-B-32", "ViT-B-32-quickgelu", "ViT-L-14"]


def _seeded_tree(init_fn, seed=3) -> dict:
    """A JAX param pytree of numpy leaves: ``init_fn``'s shapes, seeded values."""
    return fx._unflatten(fx.seeded_tree_leaves(fx.eval_shapes(init_fn), seed))


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= REL * np.abs(ref).max(), (err, np.abs(ref).max())


TOWERS = {
    "vit": dict(layers=2, width=64, patch_size=8, image_size=32),
    "vit-quick-gelu": dict(layers=2, width=64, patch_size=8, image_size=32, quick_gelu=True),
    "resnet": dict(layers=(1, 1, 1, 1), width=16, image_size=64),
    "timm-vit-avg-linear": dict(timm_model_name="vit_base_patch32_224", image_size=32),
    "timm-vit-avg-mlp": dict(timm_model_name="vit_base_patch32_224", image_size=32,
                             timm_proj="mlp"),
    "timm-vit-token-linear": dict(timm_model_name="vit_base_patch32_224", image_size=32,
                                  timm_pool=""),
    "timm-resnet-avg-linear": dict(timm_model_name="resnet50", image_size=64),
    "timm-resnet-token-mlp": dict(timm_model_name="resnet50", image_size=64, timm_pool="",
                                  timm_proj="mlp"),
    "timm-resnet-attn-linear": dict(timm_model_name="resnet50", image_size=64,
                                    timm_pool="abs_attn"),
    "timm-resnet-attn-none": dict(timm_model_name="resnet50", image_size=64,
                                  timm_pool="abs_attn", timm_proj=""),
}


@pytest.fixture
def narrow_trunks():
    with mock.patch.dict(j_vision._TRUNKS, NARROW_TRUNKS), \
            mock.patch.dict(t_vision._TRUNKS, NARROW_TRUNKS):
        yield


def _towers(kw, embed=24):
    init_fn, apply_fn = j_vision.create_vision_tower(embed, j_vision.VisionCfg(**kw))
    params = _seeded_tree(init_fn)
    tower = load_jax_params(t_vision.create_vision_tower(embed, t_vision.VisionCfg(**kw)), params)
    return params, apply_fn, tower


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_matches_jax(name, narrow_trunks):
    """Each tower on weights carried from the JAX pytree: the ViT (exact and
    quick GELU), the ModifiedResNet (its attention pool), and every timm
    pool/projection pair on both trunks."""
    kw = TOWERS[name]
    params, apply_fn, tower = _towers(kw)
    img = np.random.default_rng(4).standard_normal(
        (2, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    ref = jax.jit(apply_fn)(jax.tree.map(jnp.asarray, params), jnp.asarray(img))
    with torch.no_grad():
        got = t_vision.vision_forward(tower, torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    _close(got, ref)


def test_attention_pool_matches_jax():
    """``AttentionPool2d`` alone, on a non-square map, against
    ``attention_pool_2d``."""
    pool = t_vision.AttentionPool2d(2, 64, 4, 24, torch.Generator().manual_seed(0))
    pool.positional_embedding = torch.nn.Parameter(torch.randn(7, 64,
                                                               generator=torch.Generator()))
    x = np.random.default_rng(2).standard_normal((3, 2, 3, 64)).astype(np.float32)
    sd = {k: v.numpy() for k, v in pool.state_dict().items()}
    p = {"positional_embedding": jnp.asarray(sd["positional_embedding"]),
         **{n: {"kernel": jnp.asarray(sd[f"{n}.weight"].T), "bias": jnp.asarray(sd[f"{n}.bias"])}
            for n in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    ref = j_vision.attention_pool_2d(p, jnp.asarray(x), 4)
    with torch.no_grad():
        got = pool(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    _close(got, ref)


@pytest.mark.parametrize("kw,error,match", [
    (dict(timm_model_name="nope"), RuntimeError, "trunk registry"),
    (dict(timm_model_name="resnet50", timm_pool="rot_attn"), NotImplementedError, "rot_attn"),
    (dict(timm_model_name="vit_base_patch32_224", timm_pool="abs_attn"), ValueError, "abs_attn"),
    (dict(timm_model_name="resnet50", timm_pool="max"), ValueError, "timm_pool"),
    (dict(timm_model_name="resnet50", timm_proj=""), ValueError, "projection"),
])
def test_timm_refusals_match_jax(kw, error, match):
    with pytest.raises(error, match=match):
        j_vision.create_vision_tower(8, j_vision.VisionCfg(**kw))
    with pytest.raises(error, match=match):
        t_vision.create_vision_tower(8, t_vision.VisionCfg(**kw))


@pytest.mark.parametrize("name", ["vit", "resnet", "timm-vit-avg-mlp", "timm-resnet-attn-linear"])
def test_freeze_masks_equal_jax(name, narrow_trunks):
    """``vision_freeze_mask`` / ``lock`` at 0, 1 and 2 unlocked groups: the
    JAX mask carried by name (through the weight converter) equals the
    port's on every parameter."""
    kw = TOWERS[name]
    params, _, tower = _towers(kw)
    cfg = t_vision.VisionCfg(**kw)
    for groups in (0, 1, 2):
        jmask = j_vision.vision_freeze_mask(params, unlocked_groups=groups)
        filled = jax.tree.map(lambda m, p: np.full(np.shape(p), m), jmask, params)
        want = {k: bool(v.all()) for k, v in vision_state_dict(filled, cfg).items()}
        assert all(v.all() == v.any() for v in vision_state_dict(filled, cfg).values())
        got = t_vision.lock(tower, groups)
        assert set(got) <= set(want)
        assert got == {k: want[k] for k in got}
        assert {k for k, p in tower.named_parameters() if p.requires_grad} == {
            k for k, v in got.items() if not v}
        if groups:
            assert not all(got.values())


@pytest.mark.parametrize("name", ["rn", "vit"])
def test_vision_fixture_matches_jax_and_port(name):
    """The committed fixture: JAX's ``clip_apply`` on its seeded weights
    gives the stored outputs (no drift), and the port's ``clip_apply`` on
    the same weights agrees with them."""
    arrays = fx.load(fx.VISION_PATH)
    cfg = fx.vision_configs("audio_residual_tpu")[name]
    params = jax.tree.map(jnp.asarray, fx.vision_params(arrays, name))
    ref = jax.jit(functools.partial(j_clip.clip_apply, cfg=cfg))(
        params, jnp.asarray(arrays[f"images/{name}"]), jnp.asarray(arrays["tokens"]))
    got = fx.run_port_vision(arrays, "cpu")[name]
    for key, r in zip(fx.VISION_OUTPUT_KEYS, ref):
        np.testing.assert_allclose(np.asarray(r), arrays[f"out/{name}/{key}"], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} {key} drifted")
        _close(got[key], arrays[f"out/{name}/{key}"])


@pytest.mark.parametrize("name", VISION_CONFIGS)
def test_vision_config_maps_like_jax(name):
    """Each shipped vision config: the same CLIPConfig as the JAX
    ``_create_clip_model`` (JAX's init stubbed), and the port's model (on
    the meta device) has the JAX pytree's parameters under the converter's
    names at the same shapes (``jax.eval_shape``: no weights anywhere)."""
    with mock.patch.object(j_clip, "init_clip_params", lambda key, cfg: {}):
        _, jcfg, jmodel_cfg = j_factory.create_model(name, "transformer")
    with torch.device("meta"):
        model, tcfg, tmodel_cfg = t_factory.create_model(name, "transformer", device="meta")
    assert tmodel_cfg == jmodel_cfg and tcfg.embed_dim == jcfg.embed_dim
    assert dataclasses.asdict(tcfg.vision) == dataclasses.asdict(jcfg.vision)
    assert dataclasses.asdict(tcfg.text) == dataclasses.asdict(jcfg.text)
    shapes = jax.eval_shape(functools.partial(j_clip.init_clip_params, cfg=jcfg),
                            jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    want = {k: v.shape for k, v in clip_state_dict(zeros, jcfg).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want


def test_vision_configs_pair_with_the_clip_text_tower_only():
    with pytest.raises(RuntimeError, match="transformer"):
        t_factory.create_model("ViT-B-16", "roberta", device="meta")
    with pytest.raises(ValueError, match="no audio tower"):
        t_factory.create_audio_model("RN50", device="meta")


def test_image_transform_equals_jax():
    """Eval (short-side resize + centre crop of a non-square image, and a
    float image) and seeded train crops: the JAX HWC arrays transposed."""
    rng = np.random.default_rng(7)
    img = Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
    floats = rng.uniform(0, 1, (40, 30, 3)).astype(np.float32)
    for x in (img, floats):
        got = t_transforms.image_transform(24, is_train=False)(x)
        assert got.dtype == torch.float32 and got.shape == (3, 24, 24)
        np.testing.assert_array_equal(
            got.numpy(), j_transforms.image_transform(24, is_train=False)(x).transpose(2, 0, 1))
    for seed in (0, 1):
        got = t_transforms.image_transform(16, is_train=True)(img, np.random.default_rng(seed))
        want = j_transforms.image_transform(16, is_train=True)(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(got.numpy(), want.transpose(2, 0, 1))


def _encode_text(texts):
    h = np.asarray([sum(map(ord, t)) % 11 for t in texts], np.float32)
    return np.stack([np.cos(h), np.sin(h), 0.5 + h / 11], axis=1)


def test_imagenet_zero_shot_equals_jax():
    """The tables, the prompt-ensembled classifier, top-k counts and
    ``run_zero_shot`` with stub encoders (a tensor-returning image encoder
    for the port), and the epoch gating."""
    names, templates = t_zsi.load_imagenet_zeroshot_data()
    assert (names, templates) == j_zsi.load_imagenet_zeroshot_data()
    assert len(names) == 1000 and len(templates) == 80
    clf = t_zsi.zero_shot_classifier(_encode_text, names[:6], templates[:3])
    np.testing.assert_array_equal(clf, j_zsi.zero_shot_classifier(_encode_text, names[:6],
                                                                  templates[:3]))
    logits = np.random.default_rng(1).standard_normal((9, 6))
    target = np.arange(9) % 6
    assert t_zsi.accuracy(logits, target, (1, 2, 5)) == j_zsi.accuracy(logits, target, (1, 2, 5))
    batches = [(np.random.default_rng(i).standard_normal((4, 3)).astype(np.float32),
                np.arange(4) % 6) for i in range(3)]
    want = j_zsi.run_zero_shot(lambda x: x, clf, batches)
    assert t_zsi.run_zero_shot(lambda x: torch.from_numpy(x), clf, batches) == want
    kw = dict(classnames=names[:6], templates=templates[:3])
    for data, epoch, freq in (({}, 0, 1), ({"imagenet-val": batches}, 1, 0),
                              ({"imagenet-val": batches}, 1, 2),
                              ({"imagenet-val": batches, "imagenet-v2": batches}, 2, 2)):
        args = (lambda x: x, _encode_text, data, epoch)
        assert (t_zsi.zero_shot_eval(*args, zeroshot_frequency=freq, epochs=5, **kw)
                == j_zsi.zero_shot_eval(*args, zeroshot_frequency=freq, epochs=5, **kw))
