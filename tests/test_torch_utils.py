"""The port's utilities on the CPU, against the JAX package's where it has
them: the checkpoint diff tool (``utils/check_ckpt.py``) on saved torch
checkpoints key for key, the FLOP counts (``utils/profiling.py``) number
for number; the timer's noise guard, the trace file and the kernels' build
cache (``utils/cache.py``)."""

import os

import numpy as np
import pytest
import torch

from audio_residual_tpu.models.htsat import HTSAT_VARIANTS
from audio_residual_tpu.models.htsat import HTSATConfig as JHTSATConfig
from audio_residual_tpu.models.roberta import RobertaConfig as JRobertaConfig
from audio_residual_tpu.utils import check_ckpt as j_ck
from audio_residual_tpu.utils import profiling as j_prof
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models.htsat import HTSATConfig
from audio_residual_tpu_torch.models.roberta import RobertaConfig
from audio_residual_tpu_torch.ops.cuda import build
from audio_residual_tpu_torch.training import checkpoints
from audio_residual_tpu_torch.training import train_clap as t_tc
from audio_residual_tpu_torch.utils import cache as t_cache
from audio_residual_tpu_torch.utils import check_ckpt as t_ck
from audio_residual_tpu_torch.utils import profiling as t_prof

from . import torch_dist_workers as dw
from . import torch_port_fixture as fx


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two checkpoints of the CLAP fixture's model, before and after one
    step with the text side frozen, the second with one key more and the
    reference's ``module.`` prefixes."""
    d = tmp_path_factory.mktemp("ckpt")
    model = t_clap.build_clap(fx.port_clap_config("roberta"), seed=0, device="cpu")
    opt = t_tc.make_optimizer(model, lr=1e-3, warmup=1, total_steps=10)
    state = t_tc.init_train_state(model, opt)
    a = str(d / "a.pt")
    torch.save(checkpoints.checkpoint_payload(state, 0, "a"), a)
    step = t_tc.make_train_step(model, opt, freeze_text=True)
    step(state, {k: torch.as_tensor(v) for k, v in dw.train_batch().items()})
    payload = checkpoints.checkpoint_payload(state, 1, "b")
    sd = {f"module.{k}": v for k, v in payload["state_dict"].items()}
    sd["module.extra.weight"] = torch.ones(3)
    b = str(d / "b.pt")
    torch.save({**payload, "state_dict": sd}, b)
    return a, b, model


FILTERS = [("", ""), ("text_branch", ""), ("", "audio_branch"), ("attn", "bias")]


@pytest.mark.parametrize("include,exclude", FILTERS)
def test_check_ckpt_is_the_jax_tool_key_for_key(ckpts, include, exclude, capsys):
    a, b, _ = ckpts
    for path in (a, b):
        assert (t_ck.keys_in_state_dict(path, include, exclude)
                == j_ck.keys_in_state_dict(path, include, exclude))
    got = t_ck.check_ckpt_diff(a, b, include, exclude)
    printed = capsys.readouterr().out
    want = j_ck.check_ckpt_diff(a, b, include, exclude)
    assert got == want
    assert printed == capsys.readouterr().out  # the same report
    if not include:
        assert got["extra.weight"] == float("inf")


def test_check_ckpt_reads_modules_and_state_dicts(ckpts, tmp_path):
    a, b, model = ckpts
    diffs = t_ck.check_ckpt_diff(model, b, verbose=False)
    assert {k: v for k, v in diffs.items() if v} == {"extra.weight": float("inf")}
    from_file = t_ck.check_ckpt_diff(a, b, verbose=False)
    assert t_ck.check_ckpt_diff(torch.load(a, weights_only=True), b, verbose=False) == from_file
    trained = [k for k, v in from_file.items() if np.isfinite(v) and v > 0]
    assert any(k.startswith("audio_branch.") for k in trained)
    # the frozen text side did not move (no decay: Adam's update of a zero
    # gradient from zero moments is zero)
    assert not [k for k in trained if k.startswith("text_branch.")]
    assert t_ck.flatten_params({"a": {"b": torch.ones(2)}, "c": [np.zeros(1)]}).keys() == {
        "a.b", "c.0"}
    with pytest.raises(ValueError, match="audio_residual_tpu.utils.check_ckpt"):
        t_ck.keys_in_state_dict(str(tmp_path))


AUDIO = {"tiny": {}, "base": HTSAT_VARIANTS["base"],
         "fusion_2d": dict(enable_fusion=True, fusion_type="aff_2d"),
         "short_clip": dict(clip_samples=240000)}


@pytest.mark.parametrize("pallas_frontend", [True, False])
@pytest.mark.parametrize("name", list(AUDIO))
def test_flop_counts_are_the_jax_ones(name, pallas_frontend):
    t, j = HTSATConfig(**AUDIO[name]), JHTSATConfig(**AUDIO[name])
    assert (t_prof.htsat_flops_per_clip(t, pallas_frontend=pallas_frontend)
            == j_prof.htsat_flops_per_clip(j, pallas_frontend=pallas_frontend))
    assert (t_prof.htsat_flops_per_clip(t, 96000, pallas_frontend=pallas_frontend)
            == j_prof.htsat_flops_per_clip(j, 96000, pallas_frontend=pallas_frontend))


@pytest.mark.parametrize("seq_len", [77, 16])
def test_text_flops_are_the_jax_ones(seq_len):
    assert (t_prof.text_tower_flops_per_sample(RobertaConfig(), seq_len)
            == j_prof.text_tower_flops_per_sample(JRobertaConfig(), seq_len))


def test_measure_seconds_on_the_cpu_and_its_noise_guard():
    a = torch.randn(256, 256, generator=torch.Generator().manual_seed(0))
    attempts = []
    dt = t_prof.measure_seconds(lambda x: x @ x, (a,), iters=5, record=attempts)
    assert t_prof.MIN_SECONDS_PER_CALL <= dt < 1.0
    last = attempts[-1]
    assert dt == pytest.approx((last["t_2n"] - last["t_n"]) / last["n"])
    # each length its fastest rep: a stall only adds time
    assert len(last["reps_n"]) == len(last["reps_2n"]) == 3
    assert (last["t_n"], last["t_2n"]) == (min(last["reps_n"]), min(last["reps_2n"]))
    out = t_prof.measure_throughput(lambda x: x @ x, a, iters=5)
    assert out["items_per_sec"] == pytest.approx(256 / out["seconds_per_iter"])
    attempts = []
    with pytest.raises(t_prof.TimingUnreliableError):
        t_prof.measure_seconds(lambda x: x, (a,), record=attempts)
    assert [r["n"] for r in attempts] == [10, 40, 160]


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.trace(str(tmp_path / "trace")):
        with t_prof.annotate("matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    assert '"matmul"' in (tmp_path / "trace" / files[0]).read_text()


def test_enable_compile_cache_moves_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_libs", {})
    got = t_cache.enable_compile_cache(str(tmp_path / "a"))
    assert got == str(tmp_path / "a") and build.BUILD_DIR == (tmp_path / "a").resolve()
    assert build._target("gemm").parent == (tmp_path / "a").resolve()
    monkeypatch.setenv("ART_COMPILE_CACHE", str(tmp_path / "env"))
    assert t_cache.enable_compile_cache() == str(tmp_path / "env")
    monkeypatch.delenv("ART_COMPILE_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    default = t_cache.enable_compile_cache()
    assert default == str(tmp_path / "home" / ".cache" / "audio_residual_tpu_torch" / "kernels")
    assert os.path.isdir(default)
    # a library loaded from the current directory pins it
    monkeypatch.setattr(build, "_libs", {"gemm": object()})
    assert t_cache.enable_compile_cache(default) == default
    with pytest.raises(RuntimeError, match="already loaded"):
        t_cache.enable_compile_cache(str(tmp_path / "b"))
