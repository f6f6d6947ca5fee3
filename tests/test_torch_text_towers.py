"""The port's text towers held against the JAX package's on the CPU, at
narrow widths (2 layers, width 64, 4 heads, vocab 1000, context 16): JAX
params made from a key cross to the port through its state-dict mappings
(``audio_residual_tpu_torch/models/convert.py``), the same token ids go
through both.

Tolerances: f32 ``atol=1e-5, rtol=1e-4`` (the same f32 program, sums in
another order). RoBERTa AMP against JAX's ``compute_dtype=bfloat16``: max
rel err <= 2e-2 (one bf16 ulp of a rounded operand is 3.9e-3) and cosine >
0.99999 per row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.models import bart as j_bart
from audio_residual_tpu.models import clip_text as j_clip
from audio_residual_tpu.models import openai as j_openai
from audio_residual_tpu.models import roberta as j_roberta
from audio_residual_tpu_torch.models import bart as t_bart
from audio_residual_tpu_torch.models import clip_text as t_clip
from audio_residual_tpu_torch.models import openai as t_openai
from audio_residual_tpu_torch.models import roberta as t_roberta
from audio_residual_tpu_torch.models.convert import (bart_state_dict, clip_text_state_dict,
                                                     roberta_state_dict)

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

F32 = dict(atol=1e-5, rtol=1e-4)


def _close(got: torch.Tensor, ref, **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **(tol or F32))


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()},
                           strict=True)
    return module.eval().requires_grad_(False)


def _inputs(tmodel: str):
    text = fx.text_inputs(tmodel)
    return text["input_ids"], text["attention_mask"]


def _roberta(style: str):
    kw = fx.CLAP_TEXT_KW["bert" if style == "bert" else "roberta"]
    jcfg, tcfg = j_roberta.RobertaConfig(**kw), t_roberta.RobertaConfig(**kw)
    params = jax.tree.map(np.asarray, j_roberta.init_roberta_params(jax.random.PRNGKey(1), jcfg))
    return params, jcfg, _load(t_roberta.Roberta(tcfg), roberta_state_dict(params, ""))


@pytest.mark.parametrize("style", ["roberta", "bert"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no-mask"])
def test_roberta_matches_jax(style, with_mask):
    params, jcfg, model = _roberta(style)
    ids, mask = _inputs(style)
    mask = mask if with_mask else None
    ref = j_roberta.roberta_apply(params, jnp.asarray(ids),
                                  None if mask is None else jnp.asarray(mask), jcfg)
    got = t_roberta.roberta_apply(model, ids, mask)
    for key in ("last_hidden_state", "pooler_output"):
        assert got[key].shape == ref[key].shape
        _close(got[key], ref[key])


def test_roberta_amp_matches_jax_bf16():
    params, jcfg, model = _roberta("roberta")
    ids, mask = _inputs("roberta")
    ref = j_roberta.roberta_apply(params, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  compute_dtype=jnp.bfloat16)
    got = t_roberta.roberta_apply(model, ids, mask, compute_dtype=torch.bfloat16)
    for key in ("last_hidden_state", "pooler_output"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert got[key].dtype == torch.float32
        assert np.abs(g - r).max() / np.abs(r).max() <= 2e-2, key
        cos = (g * r).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(r, axis=-1))
        assert cos.min() > 0.99999, (key, cos.min())


def test_roberta_position_ids_match_jax():
    ids, _ = _inputs("roberta")
    for pad in (0, 1):
        np.testing.assert_array_equal(
            t_roberta.position_ids_from_input_ids(torch.from_numpy(ids), pad).numpy(),
            np.asarray(j_roberta.position_ids_from_input_ids(jnp.asarray(ids), pad)))


def test_roberta_state_dict_is_the_hf_layout():
    """Keys and values == the JAX exporter's (``roberta_params_to_state_dict``)."""
    from audio_residual_tpu.models import convert as j_convert

    params, _, model = _roberta("roberta")
    ref = j_convert.roberta_params_to_state_dict(params, "")
    sd = model.state_dict()
    assert list(sd) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "no-mask"])
def test_bart_matches_jax(with_mask):
    kw = fx.CLAP_TEXT_KW["bart"]
    jcfg = j_bart.BartConfig(**kw)
    params = jax.tree.map(np.asarray, j_bart.init_bart_params(jax.random.PRNGKey(2), jcfg))
    model = _load(t_bart.Bart(t_bart.BartConfig(**kw)), bart_state_dict(params, ""))
    ids, mask = _inputs("bart")
    mask = mask if with_mask else None
    ref = j_bart.bart_apply(params, jnp.asarray(ids), None if mask is None else jnp.asarray(mask),
                            jcfg)["encoder_last_hidden_state"]
    _close(t_bart.bart_apply(model, ids, mask)["encoder_last_hidden_state"], ref)


def _clip(quick_gelu: bool):
    kw = {**fx.CLAP_TEXT_KW["transformer"], "quick_gelu": quick_gelu}
    jcfg = j_clip.ClipTextConfig(**kw)
    params = jax.tree.map(np.asarray, j_clip.init_clip_text_params(jax.random.PRNGKey(3), jcfg))
    return params, jcfg, t_clip.ClipTextConfig(**kw)


@pytest.mark.parametrize("quick_gelu", [False, True])
def test_clip_text_matches_jax(quick_gelu):
    params, jcfg, tcfg = _clip(quick_gelu)
    model = _load(t_clip.ClipText(tcfg), clip_text_state_dict(params, "transformer.", ""))
    ids, _ = _inputs("transformer")
    ref = j_clip.clip_text_apply(params, jnp.asarray(ids), jcfg)
    got = model(ids)
    assert got.shape == (ids.shape[0], tcfg.width)
    _close(got, ref)


def test_openai_text_tower_matches_jax():
    """An OpenAI CLIP state dict (text tower plus a vision key) -> the port's
    loader and the JAX converter: the same config and the same features."""
    params, _, _ = _clip(True)
    sd = clip_text_state_dict(params, "transformer.", "")
    sd["visual.proj"] = np.zeros((8, 8), np.float32)
    model, tcfg = t_openai.load_openai_text_tower(sd, device="cpu")
    jparams, jcfg = j_openai.convert_openai_text_tower(sd)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg == t_openai.text_config_from_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    assert not any(p.requires_grad for p in model.parameters())
    ids, _ = _inputs("transformer")
    _close(model(ids), j_clip.clip_text_apply(jparams, jnp.asarray(ids), jcfg))
    assert t_openai.list_openai_models() == j_openai.list_openai_models()


def test_openai_text_tower_needs_a_card_unless_told(monkeypatch):
    params, _, _ = _clip(True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_openai.load_openai_text_tower(clip_text_state_dict(params, "transformer.", ""))


@pytest.mark.parametrize("j_cls,t_cls", [(j_roberta.RobertaConfig, t_roberta.RobertaConfig),
                                         (j_bart.BartConfig, t_bart.BartConfig),
                                         (j_clip.ClipTextConfig, t_clip.ClipTextConfig)])
def test_text_configs_match_jax(j_cls, t_cls):
    """Every field of the port's config is the JAX config's, default for
    default (JAX's RobertaConfig also has a ``dtype`` it never reads)."""
    j, t = j_cls(), t_cls()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert {f.name for f in dataclasses.fields(j)} - {f.name for f in dataclasses.fields(t)} \
        <= {"dtype"}


def test_text_towers_default_init_matches_jax_layout():
    """The towers' parameter shapes at their defaults equal the JAX trees'
    through the mappings (roberta-base, bart-base, the CLIP tower)."""
    for init, cfg, module, to_sd in (
            (j_roberta.init_roberta_params, j_roberta.RobertaConfig(), t_roberta.Roberta,
             lambda p: roberta_state_dict(p, "")),
            (j_bart.init_bart_params, j_bart.BartConfig(), t_bart.Bart,
             lambda p: bart_state_dict(p, "")),
            (j_clip.init_clip_text_params, j_clip.ClipTextConfig(), t_clip.ClipText,
             lambda p: clip_text_state_dict(p, "transformer.", ""))):
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0), cfg)
        ref = to_sd(jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes))
        with torch.device("meta"):  # shapes only: no memory, no init arithmetic
            got = {k: tuple(v.shape) for k, v in module().state_dict().items()}
        assert got == {k: v.shape for k, v in ref.items()}
