"""The contrastive cell at a tiny size on the CPU: its own tiny
configuration and traffic (the factory's model by name swapped for a
narrow one), a whole run reading ``correct``, each control failing a
limit, its per-layer readers on a synthetic trace, its counts by hand, and
its reference loading nothing of the program."""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import core, program
from benchmark import run as bench_run
from benchmark.calibrate import readings
from benchmark.core import FORBIDDEN, ROOT
from benchmark.counts import contrastive_step, roberta_forward
from benchmark.counts.htsat_forward import stage_ops
from benchmark.tests import bench_tiny
from benchmark.tests.test_bench_port_spans import AUTOGRAD, BACKWARD, _Events
from benchmark.trace import Trace

CPU = torch.device("cpu")
NAME = "contrastive.tiny-roberta.f32"
TEXT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
            layer_norm_eps=1e-5, hidden_act="gelu", hidden_dropout_prob=0.1,
            attention_probs_dropout_prob=0.1)
CONFIG = {**copy.deepcopy(bench_tiny.CONFIG), "name": "clap-test", "text": TEXT}
TRAFFIC = dict(batch=4, pool_clips=8, clip_samples=9600, context=16, tokens=[4, 12],
               id_range=[3, 99], checked_steps=2, trace_steps=2)


@pytest.fixture(autouse=True)
def tiny_factory(monkeypatch):
    """``create_model`` by name gives the tiny configuration's model."""
    from audio_residual_tpu_torch.models import clap, factory, roberta

    def create_model(amodel, tmodel="roberta", pretrained="", *, device=None, **kw):
        text = roberta.RobertaConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                                     intermediate_size=64, max_position_embeddings=40)
        cfg = dataclasses.replace(program.clap_config(CONFIG), text=text)
        return clap.build_clap(cfg, device=device), cfg, {}

    monkeypatch.setattr(factory, "create_model", create_model)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _cell() -> core.Cell:
    c = core.Cell(NAME)
    c.config = copy.deepcopy(CONFIG)
    c.traffic = {**c.traffic, **TRAFFIC}
    return c


def test_a_run_is_correct():
    line, checks = bench_run.run_cell(_cell(), 2 ** 33 + 5, 0.2, False, CPU, t_start=0.0)
    assert line["correct"], checks
    assert set(checks) == {"loss_gap", "audio_grad_gap", "text_grad_gap", "change_gap"}
    assert line["metrics"]["train_clips_per_s"]["value"] > 0


def test_a_factory_model_of_other_widths_is_refused(monkeypatch):
    c = _cell()
    c.config["text"]["intermediate_size"] = 128
    with pytest.raises(SystemExit):
        bench_run.run_cell(c, 3, 0.1, False, CPU, t_start=0.0)


@pytest.mark.parametrize("control,fault", [("tf32", None), ("f32", "half"),
                                           ("f32", "text_eval")])
def test_each_control_fails_a_limit(control, fault):
    cell = _cell()
    r = readings(cell, 11, 0.1, CPU, control, fault)
    assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
    assert any(v > cell.limits[k] for k, v in r["control"].items()), r


def _events() -> list:
    """Two steps of 1000 µs: the towers and the loss on the main thread, the
    backward's kernels on the autograd thread (some inside a recompute),
    the update after."""
    ev = _Events()
    ev.span("bench.window", 0, 2000)
    for o in (0, 1000):
        ev.span("bench.step", o, o + 1000)
        ev.span("train.forward", o + 10, o + 300)
        ev.span("encode_audio", o + 10, o + 150)
        ev.launch(o + 20, 50)
        ev.launch(o + 80, 30)
        ev.span("encode_text", o + 150, o + 290)
        ev.span("roberta.layer0", o + 160, o + 280)
        ev.launch(o + 170, 40)
        ev.span("train.loss", o + 300, o + 320)
        ev.launch(o + 305, 4)
        ev.span("train.backward", o + 330, o + 800)
        ev.launch(o + 335, 2)
        ev.span(BACKWARD, o + 340, o + 790, tid=AUTOGRAD, cat="cpu_op")
        ev.span("recompute.fused_window_attention", o + 350, o + 500, tid=AUTOGRAD)
        ev.launch(o + 360, 100, tid=AUTOGRAD)
        ev.launch(o + 600, 60, tid=AUTOGRAD)
        ev.span("train.update", o + 810, o + 990)
        ev.span("Optimizer.step#AdamW.step", o + 820, o + 980)
        ev.launch(o + 830, 80)
        ev.launch(o + 995, 1)  # the loss read back, outside the step's spans
    return ev.events


COUNTERS = {"trace_steps": 2, "mfu": 1.25, "text_bound_ms": 0.01}
EXPECTED = {  # a step's device ms, %, launches
    "audio_span_ms.contrastive": (50 + 30) / 1e3,
    "text_span_ms.contrastive": 40 / 1e3,
    "text_span_roofline.contrastive": 100.0 * 0.01 / 0.04,
    "loss_span_ms.contrastive": 4 / 1e3,
    "backward_span_ms.contrastive": (2 + 100 + 60) / 1e3,
    "update_span_ms.contrastive": 80 / 1e3,
    "launches.contrastive": 8.0,
    "mfu.contrastive": 1.25,
    "device_idle.contrastive": 100.0 * (1 - 2 * (50 + 30 + 40 + 4 + 2 + 100 + 60 + 80 + 1)
                                        / 2000),
}


def _read(metric: str, events: list, counters: dict):
    ctx = types.SimpleNamespace(trace=Trace(events, (BACKWARD,)), split=None, counters=counters)
    reader = core.load_module(core.HERE / "metrics" / f"{metric}.py",
                              "benchmark_metric_" + metric.replace(".", "_"))
    return reader.read(ctx)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_the_step(metric):
    assert _read(metric, _events(), COUNTERS) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(m for m in EXPECTED
                                          if m.split(".")[0] not in ("mfu", "device_idle")))
def test_reader_without_the_port_spans_reads_none(metric):
    harness_only = [e for e in _events()
                    if e["cat"] != "user_annotation" or e["name"].startswith("bench.")]
    counters = {k: v for k, v in COUNTERS.items() if k == "trace_steps"}
    assert _read(metric, harness_only, counters) is None


def test_every_new_reader_has_an_entry_for_the_cell():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for metric in EXPECTED:
        assert per_layer[metric]["workloads"] == [NAME]
        assert per_layer[metric]["moves"] == "train_clips_per_s"
    train = [m for m in spec["end_to_end"] if m["name"] == "train_clips_per_s"][0]
    assert NAME in train["workloads"]


def test_counts_by_hand():
    cfg = json.loads((ROOT / "benchmark" / "configs" / "clap-htsat-tiny-roberta.json")
                     .read_text())
    b, l, d, ff = 96, 77, 768, 3072
    layer = 2 * b * l * d * d * 4 + 2 * 2 * b * l * l * d + 2 * 2 * b * l * d * ff
    text = 12 * layer + 2 * b * d * d + 2 * b * (d * 512 + 512 * 512)
    assert roberta_forward.span_ops(cfg, b, l) == text
    assert round(text / 1e12, 4) == 1.2769
    audio = contrastive_step.audio_ops(cfg)
    # the backward: twice the layers' products less the patch embedding's
    # input gradient, twice the projection
    patch = 2 * 64 * 64 * 96 * 16
    st = stage_ops(cfg, classes=0)
    layers = sum(v for k, v in st.items() if k.startswith("layer"))
    assert audio["backward"] == 2 * layers - patch + 2 * 2 * (768 * 512 + 512 * 512)
    step = contrastive_step.step_ops(cfg, b, l)
    assert step == (b * (audio["forward"] + audio["backward"]) + 3 * text
                    + 2 * (2 * b * 2 * 512 * 512) + 3 * 2 * b * b * 512)
    assert roberta_forward.span_bytes(cfg, b, l) > 4 * 85e6  # the encoder's weights, f32


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, {root!r}); "
            "import benchmark.reference.clap_train, benchmark.reference.roberta; "
            "print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"audio_residual_tpu_torch", *FORBIDDEN}


def test_kinks_within_round_off_follow_the_program():
    cell = _cell()
    driver = cell.driver().Driver(bench_run.Run(cell, 1, CPU))
    z = torch.tensor([[1.0, -2.0, 0.5], [3e-5, 0.7, -1.0], [-0.4, 1.5, 1e-5]])
    dh = torch.tensor([[0.3, 0.2, -0.1], [0.25, -0.5, 0.4], [0.1, 0.2, 0.6]])
    own = (z > 0).float()
    for program_slope in (1.0, 0.0):  # the program's side of z[1, 0]
        taken = own.clone()
        taken[1, 0] = program_slope
        driver.kink_grads = [{"audio": (taken * dh).sum(0) + 1e-7, "text": (own * dh).sum(0)}]
        got = driver._resolve(0, {"audio": z, "text": z}, {"audio": dh, "text": dh})
        if program_slope == 1.0:
            assert got is None  # the reference's own side
        else:
            assert torch.equal(got["audio"], taken) and torch.equal(got["text"], own)


def test_reference_slopes_set_the_relu_derivative():
    """The reference's ReLU slopes: its own signs give the plain step; the
    entry nearest 0 flipped moves the projection's first bias gradient by
    the loss's gradient at that ReLU output (to 5%: the flip also moves the
    forward by that entry's input, the smallest of 48)."""
    from benchmark import clap_inputs, inputs
    from benchmark.reference import clap_train
    from benchmark.reference import htsat as ref

    cfg = CONFIG
    b = 3
    wav = inputs.clips(5, b, 9600, (-40.0, -6.0), CPU)
    ids, mask = clap_inputs.captions(5, b, cfg, {**TRAFFIC, "bos_id": 0, "eos_id": 2}, CPU)
    batch = {"waveform": wav, "input_ids": ids, "attention_mask": mask}
    sd = clap_inputs.weights(cfg, 5, CPU)
    opt = dict(lr=1e-3, warmup=2, total_steps=10, betas=(0.99, 0.9), eps=1e-8, weight_decay=0.0)
    seen = {}

    def run(flip):
        def resolve(t, z, dh):
            seen.update(z=z, dh=dh)
            slopes = {s: (v > 0).float() for s, v in z.items()}
            if flip:
                r, u = divmod(int(z["text"].abs().argmin()), z["text"].shape[1])
                seen["at"] = (r, u)
                slopes["text"][r, u] = 1.0 - slopes["text"][r, u]
            return slopes
        return clap_train.train_steps([batch], sd, cfg, [{}], opt, 0, ref.Precision("f32"),
                                      resolve)

    plain = clap_train.train_steps([batch], sd, cfg, [{}], opt, 0, ref.Precision("f32"))
    same, flipped = run(False), run(True)
    key = "text_projection.0.bias"
    assert same["losses"] == plain["losses"]
    assert torch.equal(same["grads"][0][key], plain["grads"][0][key])
    r, u = seen["at"]
    sign = 1.0 if seen["z"]["text"][r, u] <= 0 else -1.0
    delta = flipped["grads"][0][key] - plain["grads"][0][key]
    torch.testing.assert_close(delta[u], sign * seen["dh"]["text"][r, u], rtol=5e-2, atol=0.0)
