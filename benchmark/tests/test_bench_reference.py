"""The plain reference against the port's CPU path (its kernels' plain
versions) at a tiny HTSAT, and a lower precision failing the cells'
comparison there."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import core, inputs, program
from benchmark.calibrate import readings
from benchmark.reference import htsat as ref
from benchmark.tests import bench_tiny as tiny

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _golden_products():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _setup(seed: int):
    cfg = tiny.CONFIG
    sd = inputs.weights(cfg, seed, CPU)
    model = program.build_model(cfg, sd, CPU)
    res = {0: inputs.residual(seed, 8, 8, 0.1, 0.01, CPU)}
    wav = inputs.clips(seed, 3, 4800, (-40.0, -6.0), CPU)
    return cfg, sd, model, res, wav


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 7])
def test_reference_matches_the_port_f32(seed):
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import encode_audio
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

    cfg, sd, model, res, wav = _setup(seed)
    with torch.no_grad():
        got = encode_audio(model, featurize_batch(quantize_roundtrip(wav), 9600),
                           residual=res)["normalized"]
        want = ref.encode(wav, sd, cfg, residual=res, prec=ref.Precision("f32"),
                          quantize=True)["normalized"]
    assert torch.allclose(got, want, atol=2e-5, rtol=0)


def test_reference_taps_match_the_port():
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import encode_audio
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

    cfg, sd, model, _, wav = _setup(3)
    with torch.no_grad():
        got = encode_audio(model, featurize_batch(quantize_roundtrip(wav), 9600),
                           taps=("attention",))["layers_attention"]
        want = ref.encode(wav, sd, cfg, prec=ref.Precision("f32"), quantize=True,
                          taps=True)["attention"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["embed.tiny.amp", "lambda.tiny.f32", "analysis.tiny.f32"])
def test_port_within_and_control_beyond_the_limits(name):
    """The port's CPU path reads under the cell's limits; the reference one
    precision below the cell's (fp8 below bf16, TF32 below f32) fails at
    least one of them."""
    cell = tiny.cell(name)
    control = "fp8" if cell.traffic["compute_dtype"] == "bf16" else "tf32"
    r = readings(cell, 11, 0.2, CPU, control, None)
    assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
    assert any(v > cell.limits[k] for k, v in r["control"].items()), r


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (core.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_at_the_cells_size(name):
    """On the card, at the cell's own size, on three seeds: the port within
    the limits, the control beyond one of them."""
    if not torch.cuda.is_available():
        pytest.skip("reads the card: no CUDA device")
    cell = core.Cell(name)
    control = "fp8" if cell.traffic["compute_dtype"] == "bf16" else "tf32"
    program.use_build_dir()
    for seed in (5, 6, 7):
        r = readings(cell, seed, 1.0, torch.device("cuda:0"), control, None)
        assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
        assert any(v > cell.limits[k] for k, v in r["control"].items()), r
