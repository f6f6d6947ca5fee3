"""The port's slice (quantize -> featurize -> HTSAT + ResiDual -> projection)
held against the JAX package on the CPU, plus its structure.

Slice tolerance: the JAX parity suite's (``test_htsat_parity.py:44-46``),
``atol=2e-3, rtol=1e-3`` and embedding cosine > 0.99999. The config has
depth 2 per layer (``tests/torch_port_fixture.py``), so a shifted block, the
SW-MSA mask and the last layer's shift-0 rule all run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_residual_tpu.models import convert as j_convert
from audio_residual_tpu.models import htsat as j_htsat
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models.convert import load_jax_params
from audio_residual_tpu_torch.residual.module import init_residual_params

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fresh():
    return fx.build()


@pytest.fixture(scope="module")
def port_out(fresh):
    return fx.run_port(fresh, "cpu")


def test_committed_fixture_is_current(fresh):
    """Regenerated from the JAX package == the committed file: params and
    input exactly; outputs to 1e-5 (same f32 program, XLA CPU run again)."""
    committed = fx.load()
    assert set(committed) == set(fresh)
    assert str(committed["config"]) == str(fresh["config"])
    for k in fresh:
        if k.startswith("out/"):
            np.testing.assert_allclose(committed[k], fresh[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k != "config":
            np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    assert fx.PATH.stat().st_size < 1 << 20


@pytest.mark.parametrize("key", fx.OUTPUT_KEYS)
def test_encode_audio_matches_jax(fresh, port_out, key):
    ref, got = fresh[f"out/{key}"], port_out[key]
    assert got.shape == ref.shape, key
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)
    if key in ("embedding", "normalized"):
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
        assert cos.min() > 0.99999, cos


def test_amp_path_runs_the_guard_on_cpu(fresh, port_out):
    """bf16 AMP against the golden f32 port: the bench guard's bounds."""
    amp = fx.run_port(fresh, "cpu", compute_dtype=torch.bfloat16)
    a, g = amp["normalized"], port_out["normalized"]
    assert (a * g).sum(-1).min() > 0.999


def test_state_dict_matches_jax_converter():
    """Keys and values == the audio side of ``clap_params_to_state_dict``."""
    params = fx.jax_params()
    ref = {k: np.asarray(v) for k, v in j_convert.clap_params_to_state_dict(params).items()
           if k.startswith(("audio_branch.", "audio_projection."))}
    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW), **fx.CLAP_KW)
    fresh_model = t_clap.build_clap_audio(cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in fresh_model.state_dict().items()}
    assert shapes == {k: v.shape for k, v in ref.items()}
    model = load_jax_params(fresh_model, {k: params[k] for k in ("audio_branch", "audio_projection")})
    sd = model.state_dict()
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert not any(p.requires_grad for p in model.parameters())


def test_variants_and_config_match_jax():
    assert t_htsat.HTSAT_VARIANTS == j_htsat.HTSAT_VARIANTS
    j, t = j_htsat.HTSATConfig(), t_htsat.HTSATConfig()
    for name in t.__dataclass_fields__:
        if name in j.__dataclass_fields__:
            assert getattr(t, name) == getattr(j, name), name
    for i in range(t.num_layers):
        assert t.layer_resolution(i) == j.layer_resolution(i)
    assert (t.num_features, t.tscam_sf, t.freq_ratio) == (j.num_features, j.tscam_sf, j.freq_ratio)
    assert t.frontend_config.num_frames(480000) == 1001


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without pulling
    in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import audio_residual_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "new = ['ops.spec_augment', 'training.losses', 'training.scheduler',\n"
        "       'training.train_clap', 'training.checkpoints', 'training.logger',\n"
        "       'training.params', 'training.main', 'training.infer_demo', 'utils.misc',\n"
        "       'data.toy', 'parallel.distributed', 'parallel.mesh', 'ops.fusion',\n"
        "       'models.pann', 'data.datasets', 'native', 'training.lp_main',\n"
        "       'evaluate.eval_zeroshot_classification', 'parallel.fsdp',\n"
        "       'utils.profiling', 'utils.check_ckpt', 'utils.cache', 'dryrun']\n"
        "missing = [m for m in new if p.__name__ + '.' + m not in names]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'audio_residual_tpu' or m.startswith('audio_residual_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_point_without_device_needs_a_card(monkeypatch):
    """``device=None`` means the card: every entry point that builds a model
    raises without one, the full CLAP's (``build_clap``, ``create_model``,
    ``CLAPModule``), the training slice's (``training.main``,
    ``infer_demo``, ``init_distributed``, ``data_parallel_mesh``) and the
    towers-and-data slice's (PANN and fusion models, ``lp_main``, the
    zero-shot CLI, ``get_mel``) too."""
    from audio_residual_tpu_torch.data.featurize import DEFAULT_AUDIO_CFG, get_mel
    from audio_residual_tpu_torch.evaluate import eval_zeroshot_classification
    from audio_residual_tpu_torch.models import factory as t_factory
    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.training import lp_main
    from audio_residual_tpu_torch.parallel.distributed import init_distributed
    from audio_residual_tpu_torch.parallel.mesh import data_parallel_mesh
    from audio_residual_tpu_torch.training import infer_demo
    from audio_residual_tpu_torch.training import main as t_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW), **fx.CLAP_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_clap.build_clap_audio(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_residual_params(np.eye(4), np.zeros(4))
    assert t_clap.build_clap_audio(cfg, device="cpu").cfg == cfg
    full = fx.port_clap_config("bart")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_clap.build_clap(full)
    assert t_clap.build_clap(full, device="cpu").cfg == full
    with torch.device("meta"):  # the check comes before any weight is made
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_factory.create_model("HTSAT-tiny", "bart")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CLAPModule(tmodel="bart")
        # the training slice's entry points: the CLI, the demo, the rendezvous
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_main.main(["--dataset-type", "toy"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            infer_demo.main([])
        # this slice's: PANN and fusion models, the fold CLIs, the fusion mel
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_factory.create_model("PANN-14")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CLAPModule(enable_fusion=True, tmodel="bart")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lp_main.main([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_zeroshot_classification.main(["--tmodel", "bart"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_mel(np.zeros(4800, np.float32), DEFAULT_AUDIO_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_parallel_mesh()
