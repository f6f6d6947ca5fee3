"""The port's contrastive train step held against the benchmark's plain
reference (``benchmark/reference/clap_train.py``, which imports nothing of
the port) on the CPU, at a small HTSAT of the published structure (two
layers of depth 2, window 4, drop-path 0.1) and a RoBERTa of two layers of
width 32, four heads and a vocabulary of 100, B=4:

* two steps of ``make_train_step`` with a generator, every draw of the
  program (SpecAugment, drop-path, RoBERTa's dropout) drawn again from
  each step's seed through the port's samplers and fed to the reference:
  the losses, each side's first gradient and the parameters' change after
  AdamW;
* RoBERTa's dropout: the masks' shapes and rate, their places (the tower
  with masks against the reference with the same masks), reproducible
  from a seed and drawn by ``encode_text`` exactly as the sampler draws
  them;
* no randomness without a generator: the step is the reference's step
  without any mask;
* the contrastive step's spans under a profiler.

Tolerances: both sides run the same f32 mathematics with sums in other
orders (the port's CPU route runs its kernels' plain versions); over two
towers of ~20 products a path the losses agree to ~5e-7 relative, the
gradients to ~1e-6 and the change to ~3e-6, so the loss is held at
``rtol=1e-5`` and each side's gradient and the change at a relative L2
error of 2e-5 and 1e-4, the change over the components whose reference
gradient is above a thousandth of the step's RMS gradient (AdamW turns a
gradient of round-off size into a full move of either sign; the rule of
``benchmark/drivers/contrastive.py``).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models import roberta as t_roberta
from audio_residual_tpu_torch.ops.spec_augment import sample_spec_augment
from audio_residual_tpu_torch.training import train_clap as t_tc
from benchmark import clap_inputs, inputs, program
from benchmark.counts.htsat_forward import frames
from benchmark.reference import clap_train
from benchmark.reference import htsat as ref
from benchmark.reference import roberta as ref_roberta
from benchmark.tests import bench_tiny

from .torch_threads import one_cpu_thread  # noqa: F401

B, CONTEXT, STEPS = 4, 12, 2
TEXT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
            layer_norm_eps=1e-5, hidden_act="gelu", hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
CFG = {**copy.deepcopy(bench_tiny.CONFIG), "text": TEXT}
CAPTIONS = dict(context=CONTEXT, tokens=[4, 10], id_range=[3, 99], bos_id=0, eos_id=2)
OPT = dict(lr=1e-3, warmup=2, total_steps=10, betas=(0.99, 0.9), eps=1e-8, weight_decay=0.1)
SEED = 2 ** 33 + 17


def _port_config() -> t_clap.CLAPConfig:
    text = t_roberta.RobertaConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                                   intermediate_size=64, max_position_embeddings=40)
    return dataclasses.replace(program.clap_config(CFG), text=text)


def _model():
    """The port's CLAP holding the benchmark's seeded weights (strictly)."""
    model = t_clap.build_clap(_port_config(), device="cpu")
    model.load_state_dict(clap_inputs.weights(CFG, SEED, torch.device("cpu")), strict=True)
    return model


def _batches() -> list:
    cpu = torch.device("cpu")
    wav = inputs.clips(SEED, B * STEPS, CFG["audio"]["clip_samples"], (-40.0, -6.0), cpu)
    ids, mask = clap_inputs.captions(SEED, B * STEPS, CFG, CAPTIONS, cpu)
    return [{"waveform": wav[i:i + B], "input_ids": ids[i:i + B], "attention_mask": mask[i:i + B]}
            for i in range(0, B * STEPS, B)]


def _draws(step_seeds: list, mcfg) -> list:
    """Each step's masks from its seed, in the program's order: the towers'
    generator, ``clap_apply``'s split (audio, the two transforms, then the
    text tower), SpecAugment and the blocks' drop-path from the audio
    stream, RoBERTa's dropout from the text stream."""
    out = []
    for seed in step_seeds:
        g = torch.Generator().manual_seed(seed)
        g_audio, _, _ = t_clap.split_generator(g, 3)
        (g_text,) = t_clap.split_generator(g, 1)
        a = CFG["audio"]
        spec = sample_spec_augment(g_audio, (B, frames(a), a["mel_bins"]))
        drop = [tuple(t_htsat.sample_drop_path(g_audio, B, float(r)) for _ in range(2))
                if r > 0 else None for r in t_htsat.drop_path_rates(mcfg.audio)]
        out.append({"spec": spec, "drop_path": drop,
                    "text": t_roberta.sample_dropout(g_text, mcfg.text, B, CONTEXT)})
    return out


def _program(generator) -> dict:
    model = _model()
    optimizer = t_tc.make_optimizer(model, lr=OPT["lr"], beta1=OPT["betas"][0],
                                    beta2=OPT["betas"][1], eps=OPT["eps"],
                                    weight_decay=OPT["weight_decay"], warmup=OPT["warmup"],
                                    total_steps=OPT["total_steps"])
    state = t_tc.init_train_state(model, optimizer)
    step = t_tc.make_train_step(model, optimizer)
    losses, first = [], None
    for batch in _batches():
        state, metrics = step(state, batch, generator)
        losses.append(float(metrics["loss"]))
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return {"losses": losses, "grad": first, "params": dict(model.named_parameters())}


def _rel(a: dict, b: dict, keys) -> float:
    err = sum(float((a[k] - b[k]).double().square().sum()) for k in keys)
    return (err / sum(float(b[k].double().square().sum()) for k in keys)) ** 0.5


def _compare(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    g0 = want["grads"][0]
    for side in (("audio_branch.", "audio_projection."), ("text_branch.", "text_projection.")):
        assert _rel(got["grad"], g0, [k for k in g0 if k.startswith(side)]) < 2e-5, side
    sd = clap_inputs.weights(CFG, SEED, torch.device("cpu"))
    err = norm = 0.0
    for k, p in want["params"].items():
        keep = torch.ones_like(p, dtype=torch.bool)
        for g in want["grads"]:
            sq = sum(float(v.double().square().sum()) for v in g.values())
            rms = (sq / sum(v.numel() for v in g.values())) ** 0.5
            keep &= g[k].abs() > 1e-3 * rms
        d, d_ref = (got["params"][k].detach() - sd[k])[keep], (p - sd[k])[keep]
        err += float((d - d_ref).double().square().sum())
        norm += float(d_ref.double().square().sum())
    assert norm > 0 and (err / norm) ** 0.5 < 1e-4


@pytest.fixture(autouse=True)
def _f32_products():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _reference(draws) -> dict:
    return clap_train.train_steps(_batches(), clap_inputs.weights(CFG, SEED, torch.device("cpu")),
                                  CFG, draws, OPT, 0, ref.Precision("f32"))


def test_two_steps_with_a_generator_match_the_reference():
    generator = torch.Generator().manual_seed(5)
    got = _program(generator)
    again = torch.Generator().manual_seed(5)
    seeds = [int(torch.randint(0, 2 ** 62, (1,), generator=again)) for _ in range(STEPS)]
    want = _reference(_draws(seeds, _port_config()))
    _compare(got, want)
    # the text tower's draws are in the step: without them the loss differs
    blind = _draws(seeds, _port_config())
    for d in blind:
        d["text"] = None
    assert abs(_reference(blind)["losses"][0] - got["losses"][0]) > 1e-3


def test_no_randomness_without_a_generator():
    got = _program(None)
    _compare(got, _reference([{}] * STEPS))


def test_roberta_dropout_masks_rate_places_and_seed():
    cfg = _port_config().text
    b, l = 8, CONTEXT

    def draw(seed):
        return t_roberta.sample_dropout(torch.Generator().manual_seed(seed), cfg, b, l)

    m, again, other = draw(3), draw(3), draw(4)
    assert m["rate"] == t_roberta.DROPOUT == 0.1
    assert m["embed"].shape == (b, l, 32) and len(m["layers"]) == 2
    for probs, attn, ffn in m["layers"]:
        assert probs.shape == (b, 4, l, l) and attn.shape == ffn.shape == (b, l, 32)
    flat = torch.cat([m["embed"].flatten()] + [k.flatten() for ks in m["layers"] for k in ks])
    assert flat.dtype == torch.bool and 0.88 < flat.float().mean() < 0.92
    assert torch.equal(m["embed"], again["embed"]) and not torch.equal(m["embed"], other["embed"])
    # places: the tower with the masks is the reference with the same masks
    model = _model()
    (batch,) = _batches()[:1]
    ids, mask = batch["input_ids"][:B], batch["attention_mask"][:B]
    masks = t_roberta.sample_dropout(torch.Generator().manual_seed(3), cfg, B, l)
    got = t_roberta.roberta_apply(model.text_branch, ids, mask, dropout=masks)["pooler_output"]
    w = clap_inputs.weights(CFG, SEED, torch.device("cpu"))
    want = ref_roberta.encode(ids, mask, w, TEXT, masks, ref.Precision("f32"))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    plain = t_roberta.roberta_apply(model.text_branch, ids, mask)["pooler_output"]
    assert not torch.allclose(got, plain, atol=1e-3)
    # encode_text in training draws exactly the sampler's masks
    drawn = t_clap.encode_text(model, ids, mask, train=True,
                               generator=torch.Generator().manual_seed(3))
    assert torch.equal(drawn, t_clap.l2_normalize(model.text_projection(got)))
    assert torch.equal(t_clap.encode_text(model, ids, mask, train=True),
                       t_clap.encode_text(model, ids, mask))


def test_contrastive_step_spans():
    model = _model()
    optimizer = t_tc.make_optimizer(model)
    state = t_tc.init_train_state(model, optimizer)
    step = t_tc.make_train_step(model, optimizer)
    batch = _batches()[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, torch.Generator().manual_seed(1))
    names = {e.name for e in prof.events() if e.is_user_annotation}
    assert {"train.forward", "train.loss", "train.backward", "train.update", "encode_audio",
            "encode_text", "roberta.embed", "roberta.layer0", "roberta.layer1",
            "roberta.pooler"} <= names
