"""The port's multi-card dry run (``audio_residual_tpu_torch/dryrun.py``) on
the CPU: every stage at the tiny size over 2 gloo processes, each stage's
record printed as it finishes, then the summary; stage 2b's loss equal to
stage 2's (``dryrun.LOSS_TOL``, the JAX dry run's) and stage 4's one process
equal to stage 2's two; and the zero-shot entry point's forward."""

import json

import numpy as np
import pytest
import torch

from audio_residual_tpu_torch import dryrun

from . import torch_dist_workers as dw


def _records(out: str):
    stages = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
              if line.startswith("DRYRUN_STAGE ")]
    summary = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
               if line.startswith("DRYRUN ")]
    return stages, summary


def test_tiny_stages_print_a_record_each_before_the_summary(capfd):
    summary = dryrun.dryrun_multichip(2, device="cpu", size="tiny", timeout_s=dw.TIMEOUT_S)
    out = capfd.readouterr().out
    stages, printed = _records(out)
    assert [s["stage"] for s in stages] == list(dryrun.STAGES)
    assert all(s["ok"] for s in stages)
    assert printed == [summary] and summary["ok"] and summary["dryrun"]["exit_codes"] == [0, 0]
    lines = out.splitlines()
    assert max(i for i, line in enumerate(lines) if line.startswith("DRYRUN_STAGE ")) < next(
        i for i, line in enumerate(lines) if line.startswith("DRYRUN "))
    by = {s["stage"]: s for s in stages}
    np.testing.assert_allclose(by["2b"]["loss"], by["2"]["loss"], **dryrun.LOSS_TOL)
    assert by["2b"]["word_embedding_before"]["local_shape"] == [300, 32]
    assert by["2b"]["word_embedding_after"]["sharded"]
    np.testing.assert_allclose(by["4"]["loss_1"], by["2"]["loss"],
                               **dryrun.N_VS_1_TOL["loss"])
    assert by["3"]["embed_dim"] == 32


def test_a_failing_stage_prints_its_record_then_raises(capfd):
    def fails():
        raise AssertionError("loss 1.0 vs 2.0")

    with pytest.raises(AssertionError):
        dryrun._stage("2b", 0, fails)
    dryrun._stage("1", 1, lambda: {"loss": 1.0})  # rank 1 prints nothing
    stages, _ = _records(capfd.readouterr().out)
    assert len(stages) == 1 and stages[0]["stage"] == "2b" and not stages[0]["ok"]
    assert stages[0]["error"] == "AssertionError: loss 1.0 vs 2.0"


def test_stages_held_against_stage_2_need_it():
    with pytest.raises(ValueError, match="stage 2"):
        dryrun.dryrun_multichip(2, stages=("1", "2b"), device="cpu")


def test_entry_is_the_zero_shot_forward():
    fn, args = dryrun.entry("cpu")
    out = fn(*args)
    assert out.shape == (2, 512) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.norm(dim=-1).numpy(), 1.0, atol=1e-5)
