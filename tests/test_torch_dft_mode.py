"""``HTSATConfig.dft_mode`` in the port, as the JAX package has it
(``audio_residual_tpu/models/htsat.py:85,698-700``): set, it picks the
frontend DFT's mode whatever the compute dtype; unset, the mode follows the
compute dtype. On the CPU K1's wrapper runs its plain version; the card's
twin of these tests is in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import unittest.mock as mock

import numpy as np
import pytest
import torch

from audio_residual_tpu.models import htsat as j_htsat
from audio_residual_tpu_torch.models import htsat as t_htsat

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

CFG = t_htsat.HTSATConfig(**fx.AUDIO_KW)
BF16 = torch.bfloat16


def forward_logmel(cfg, compute_dtype, device="cpu"):
    """``(dft mode, log-mel)`` that one ``htsat_apply`` gave K1, on a seeded
    model and input."""
    model = t_htsat.HTSAT(cfg).to(device)
    wav = np.random.default_rng(0).standard_normal((2, cfg.clip_samples)) * 0.1
    wav = torch.from_numpy(wav.astype(np.float32)).to(device)
    seen, real = {}, t_htsat.fused_logmel

    def capture(w, fcfg, dft_mode=None):
        seen["mode"], seen["logmel"] = dft_mode, real(w, fcfg, dft_mode)
        return seen["logmel"]

    with mock.patch.object(t_htsat, "fused_logmel", capture), torch.no_grad():
        t_htsat.htsat_apply(model, wav, compute_dtype=compute_dtype)
    return seen["mode"], seen["logmel"]


def test_the_field_matches_the_jax_config():
    jf = {f.name: f for f in dataclasses.fields(j_htsat.HTSATConfig)}["dft_mode"]
    tf = {f.name: f for f in dataclasses.fields(t_htsat.HTSATConfig)}["dft_mode"]
    assert tf.default is jf.default is None
    assert str(tf.type) == str(jf.type) == "str | None"


@pytest.mark.parametrize("compute_dtype,mode", [(None, "f32"), (BF16, "bf16")])
def test_unset_the_mode_follows_the_compute_dtype(compute_dtype, mode):
    assert forward_logmel(CFG, compute_dtype)[0] == mode


def test_amp_forward_with_f32_dft_gives_the_golden_logmel():
    mode, amp = forward_logmel(dataclasses.replace(CFG, dft_mode="f32"), BF16)
    _, golden = forward_logmel(CFG, None)
    assert mode == "f32"
    assert torch.equal(amp, golden)


def test_golden_forward_with_bf16_dft_gives_the_amp_logmel():
    mode, golden = forward_logmel(dataclasses.replace(CFG, dft_mode="bf16"), None)
    _, amp = forward_logmel(CFG, BF16)
    assert mode == "bf16"
    assert torch.equal(golden, amp)
    assert not torch.equal(amp, forward_logmel(CFG, None)[1])  # the modes differ


def test_bf16x3_is_not_carried_over():
    with pytest.raises(ValueError, match="TPU-only"):
        forward_logmel(dataclasses.replace(CFG, dft_mode="bf16x3"), BF16)
