"""The port's training CLI on the CPU: the flag parser against the JAX
package's (so every launch script that parses there parses here), ``main``
on a toy h5 set (logs, ``params.txt``, checkpoints, the top-K rotation,
validation records), a resume that reproduces the uninterrupted run bit for
bit, ``main --fsdp`` in 2 gloo processes (the checkpoint of a run without
it, which loads into an unsharded model; a resume that reproduces the
uninterrupted run), ``main --fsdp`` in this process (a world of one) whose
checkpoints, written or resumed with FSDP or without it, hold the layout and,
by parameter name, the state of the run without it, the checkpoint helpers'
rotation, and ``infer_demo``.

The model is the CLAP fixture's narrow one (``factory.create_model``
swapped), the tokenizer ``HashTokenizer``; the run is golden f32.
"""

import argparse
import os
import shlex
import unittest.mock as mock

import numpy as np
import pytest
import torch

from audio_residual_tpu.training import params as j_params
from audio_residual_tpu_torch.data.toy import ToyDataset, make_toy_h5
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models.convert import load_clap_checkpoint
from audio_residual_tpu_torch.training import checkpoints, infer_demo
from audio_residual_tpu_torch.training import main as t_main
from audio_residual_tpu_torch.training import params as t_params
from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

from . import torch_dist_workers as dw
from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

CLIP = fx.AUDIO_KW["clip_samples"]


def _parser(module) -> argparse.ArgumentParser:
    """The ``argparse`` parser ``module.parse_args`` builds."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        seen.append(self)
        return real(self, *a, **k)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", spy):
        module.parse_args([])
    return seen[0]


def test_every_flag_parses_with_the_jax_packages_default():
    """Option by option: the same strings, defaults, choices, nargs and
    action kinds as the JAX package's parser; so every reference launch
    script that parses there (``tests/test_aux.py``) parses here."""
    def table(p):
        return {s: (a.dest, a.default, tuple(a.choices or ()), a.nargs, type(a).__name__)
                for a in p._actions for s in a.option_strings}

    assert table(_parser(t_params)) == table(_parser(j_params))


LAUNCH_LINES = [
    # the shapes of the reference's experiment scripts' payloads
    "--save-frequency 5 --save-top-performance 3 --save-most-recent --dataset-type webdataset "
    "--precision fp32 --batch-size 96 --lr 1e-4 --wd 0.0 --epochs 45 --workers 6 "
    "--use-bn-sync --amodel HTSAT-tiny --tmodel roberta --warmup 3200 --report-to wandb "
    "--wandb-notes 10.16-clap-dataset#5 --datasetnames Clotho audiocaps --datasetinfos train "
    "--top-k-checkpoint-select-dataset Clotho-test --top-k-checkpoint-select-metric mAP@10 "
    "--logs logs/ --seed 3407 --gather-with-grad --optimizer adam --data-filling "
    "repeatpad --data-truncating rand_trunc --pretrained-audio /x/HTSAT.ckpt",
    "--split-opt --lr-pretrained 1e-5 --lr-new 1e-4 --wd-pretrained 0.1 --freeze-text "
    "--enable-fusion --fusion-type aff_2d --mlp-loss --kappa 0.5 --local-loss --remat "
    "--dataset-type toy --train-ipc a.npy --prefetch-factor 2 --resume x.pt",
]


@pytest.mark.parametrize("line", LAUNCH_LINES)
def test_launch_lines_parse_the_same_in_both_packages(line):
    flags = shlex.split(line)
    t, j = vars(t_params.parse_args(flags)), vars(j_params.parse_args(flags))
    assert t == j


_narrow_create_model = dw.narrow_create_model


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    d = tmp_path_factory.mktemp("toy")
    train = make_toy_h5(str(d / "train.h5"), num_samples=8, num_classes=4, clip_samples=CLIP)
    val = make_toy_h5(str(d / "val.h5"), num_samples=4, num_classes=4, clip_samples=CLIP,
                      seed=1)
    return train, val


def _argv(logs, toy, name, *extra) -> list:
    train, val = toy
    return ["--dataset-type", "toy", "--train-data", train, "--val-data", val,
            "--batch-size", "4", "--train-num-samples", "8", "--epochs", "2",
            "--precision", "fp32", "--lr", "1e-4", "--warmup", "1", "--logs", str(logs),
            "--name", name, "--save-top-performance", "2", "--save-most-recent",
            "--seed", "7", "--log-local", *extra]


def _run(logs, toy, name, *extra):
    argv = _argv(logs, toy, name, *extra)
    tok = HashTokenizer(vocab_size=1000, context_length=fx.CLAP_CONTEXT)
    with mock.patch.object(t_factory, "create_model", _narrow_create_model):
        return t_main.main(argv, device="cpu", tokenizer=tok)


@pytest.fixture(scope="module")
def run(tmp_path_factory, toy):
    logs = tmp_path_factory.mktemp("logs")
    return logs, _run(logs, toy, "run")


def test_main_trains_on_the_toy_set_and_writes_its_files(run):
    logs, out = run
    base = logs / "run"
    assert out["steps"] == 4  # 2 epochs of 8 clips at batch 4
    for f in ("out.log", "params.txt", "results.jsonl", "checkpoints/epoch_0.pt",
              "checkpoints/epoch_1.pt", "checkpoints/epoch_latest.pt",
              "checkpoints/pretrain_performance_0.pt"):
        assert (base / f).exists(), f
    assert "amodel: HTSAT-tiny" in (base / "params.txt").read_text()
    records = (base / "results.jsonl").read_text().splitlines()
    assert len(records) == 3  # validation before training and after each epoch
    assert np.isfinite(out["metrics"]["all/cumulative_loss"])
    assert sorted(out["top_k"]) == [0, 1]
    ckpt = torch.load(base / "checkpoints/epoch_1.pt", weights_only=True)
    assert set(ckpt) == {"epoch", "name", "state_dict", "optimizer", "step"}
    assert ckpt["epoch"] == 1 and ckpt["name"] == "run" and ckpt["step"] == 4
    model = out["state"]["model"]
    for k, v in model.state_dict().items():
        assert torch.equal(ckpt["state_dict"][k], v), k


def test_resume_reproduces_the_uninterrupted_run(run, toy, tmp_path):
    logs, out = run
    resumed = _run(tmp_path, toy, "resumed", "--resume",
                   str(logs / "run" / "checkpoints" / "epoch_0.pt"))
    assert resumed["steps"] == 4
    want = out["state"]["model"].state_dict()
    for k, v in resumed["state"]["model"].state_dict().items():
        assert torch.equal(v, want[k]), k
    a = out["state"]["optimizer"].state_dict()["state"]
    b = resumed["state"]["optimizer"].state_dict()["state"]
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)


def test_main_refuses_what_is_not_ported(tmp_path, toy):
    """``csv`` (the reference raises) refuses; ``webdataset`` reads tar
    shards (``tests/test_torch_shards.py``), and under the toy file, which
    holds none, it takes no step. (``--fsdp`` runs: the tests below.)"""
    assert _run(tmp_path, toy, "shards", "--dataset-type", "webdataset")["steps"] == 0
    with pytest.raises(ValueError, match="Unsupported dataset type"):
        _run(tmp_path, toy, "csv", "--dataset-type", "csv")


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory, toy):
    """``main --fsdp`` on 2 gloo ranks: a run, then one resumed from its
    first epoch's checkpoint."""
    logs = tmp_path_factory.mktemp("fsdp_logs")
    argv = _argv(logs, toy, "fsdp", "--fsdp")
    resume = _argv(logs, toy, "fsdp_resumed", "--fsdp", "--resume",
                   str(logs / "fsdp" / "checkpoints" / "epoch_0.pt"))
    ranks = dw.run("fsdp_main_worker", 2, str(tmp_path_factory.mktemp("fsdp_out")), argv,
                   resume)
    return logs, ranks


def test_main_fsdp_trains_and_saves_the_unsharded_checkpoint(fsdp_run, run):
    logs, ranks = fsdp_run
    assert [r["run"]["steps"] for r in ranks] == [4, 4]
    base = logs / "fsdp"
    assert "fsdp: True" in (base / "params.txt").read_text().splitlines()
    assert len((base / "results.jsonl").read_text().splitlines()) == 3  # rank 0 writes
    for f in ("epoch_0.pt", "epoch_1.pt", "epoch_latest.pt", "pretrain_performance_0.pt"):
        assert (base / "checkpoints" / f).exists(), f
    got = torch.load(base / "checkpoints/epoch_1.pt", weights_only=True)
    want = torch.load(run[0] / "run" / "checkpoints/epoch_1.pt", weights_only=True)
    assert set(got) == set(want) and got["step"] == want["step"] == 4
    assert got["state_dict"].keys() == want["state_dict"].keys()
    assert got["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    for k, v in got["state_dict"].items():
        assert v.shape == want["state_dict"][k].shape and torch.isfinite(v.float()).all(), k
    # (the values differ from the one-process run's: each rank draws the
    # epoch's randomness for its own rows; tests/test_torch_fsdp.py holds
    # the step without randomness against one process)
    # the file loads into a model without FSDP
    model = load_clap_checkpoint(t_clap.build_clap(fx.port_clap_config("roberta"), seed=1,
                                                   device="cpu"),
                                 str(base / "checkpoints/epoch_1.pt"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["state_dict"][k]), k


def test_main_fsdp_resume_reproduces_the_uninterrupted_run(fsdp_run):
    logs, ranks = fsdp_run
    assert [r["resumed"]["steps"] for r in ranks] == [4, 4]
    want = torch.load(logs / "fsdp" / "checkpoints/epoch_1.pt", weights_only=True)
    got = torch.load(logs / "fsdp_resumed" / "checkpoints/epoch_1.pt", weights_only=True)
    for k, v in want["state_dict"].items():
        assert torch.equal(got["state_dict"][k], v), k
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    a, b = want["optimizer"]["state"], got["optimizer"]["state"]
    assert a.keys() == b.keys()
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k]), (i, k)


def _moments_by_name(ckpt: dict, model) -> dict:
    """A checkpoint's optimizer state by parameter name: the file's groups
    hold the ids in the order of the unsharded model's groups (decayed
    parameters, then the others, each in ``named_parameters()`` order)."""
    params = list(model.named_parameters())
    order = [n for n, p in params if p.ndim >= 2] + [n for n, p in params if p.ndim < 2]
    ids = [i for g in ckpt["optimizer"]["param_groups"] for i in g["params"]]
    assert sorted(ids) == list(range(len(order)))
    return {order[i]: ckpt["optimizer"]["state"][i] for i in ids}


def _assert_same_training_state(got: dict, want: dict, model) -> None:
    """Two checkpoints of one run: the same keys, parameter groups and
    step; every parameter within the f32 bounds of
    ``tests/test_torch_distributed.py``, and every Adam moment, by name,
    within ``torch_dist_workers.assert_moments_close``'s."""
    assert got["step"] == want["step"]
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]
    assert got["state_dict"].keys() == want["state_dict"].keys()
    for k, v in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=k)
    a, b = _moments_by_name(got, model), _moments_by_name(want, model)
    shapes = dict(model.named_parameters())
    for name, moments in b.items():
        assert moments["exp_avg"].shape == shapes[name].shape, name
    dw.assert_moments_close(a, b)


@pytest.fixture(scope="module")
def one_rank_fsdp(tmp_path_factory, toy, run):
    """In this process (a world of one, sharded over a group of its own):
    ``main --fsdp``; ``main --fsdp`` resumed from the first checkpoint of
    the run without FSDP; ``main`` without FSDP resumed from the first
    checkpoint of the FSDP run."""
    logs = tmp_path_factory.mktemp("fsdp1_logs")
    out = {"fsdp": _run(logs, toy, "fsdp", "--fsdp")}
    assert not torch.distributed.is_initialized()  # main destroyed the group it made
    out["fsdp_from_plain"] = _run(logs, toy, "fsdp_from_plain", "--fsdp", "--resume",
                                  str(run[0] / "run" / "checkpoints" / "epoch_0.pt"))
    out["plain_from_fsdp"] = _run(logs, toy, "plain_from_fsdp", "--resume",
                                  str(logs / "fsdp" / "checkpoints" / "epoch_0.pt"))
    assert not torch.distributed.is_initialized()
    return logs, out


@pytest.mark.parametrize("name", ["fsdp", "fsdp_from_plain", "plain_from_fsdp"])
def test_fsdp_checkpoints_are_placement_free(one_rank_fsdp, run, name):
    """Each run's last checkpoint against the run without FSDP: the same
    file layout (parameter groups and their ids) and, by name, the same
    parameters and Adam moments, whether it was written or resumed with
    FSDP or without it."""
    logs, out = one_rank_fsdp
    assert out[name]["steps"] == 4
    got = torch.load(logs / name / "checkpoints" / "epoch_1.pt", weights_only=True)
    want = torch.load(run[0] / "run" / "checkpoints" / "epoch_1.pt", weights_only=True)
    _assert_same_training_state(got, want, run[1]["state"]["model"])


def test_fsdp_load_refuses_another_group_layout(one_rank_fsdp, run, toy, tmp_path):
    """A file whose optimizer groups do not match this optimizer's is
    refused, not loaded onto the wrong parameters."""
    ckpt = torch.load(run[0] / "run" / "checkpoints" / "epoch_0.pt", weights_only=True)
    groups = ckpt["optimizer"]["param_groups"]
    groups[0]["params"], moved = groups[0]["params"][:-1], groups[0]["params"][-1]
    groups[1]["params"].insert(0, moved)
    torch.save(ckpt, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="parameter groups"):
        _run(tmp_path, toy, "bad", "--fsdp", "--resume",
             str(tmp_path / "bad.pt"))
    assert not torch.distributed.is_initialized()


def test_toy_dataset_queue_and_text(toy):
    ds = ToyDataset(toy[0])
    assert len(ds) == 8 and set(ds.queue) <= set(range(8))
    item = ds[0]
    assert item["waveform"].shape == (CLIP,) and item["text"].startswith("The sounds of ")
    batches = list(ds.batches(3))
    assert [len(b["text"]) for b in batches] == [3, 3, 2]
    assert list(ToyDataset(toy[1], eval_mode=True).queue) == [0, 1, 2, 3]


def _state(value: float):
    model = torch.nn.Linear(2, 2)
    with torch.no_grad():
        model.weight.fill_(value)
    return {"model": model, "optimizer": torch.optim.SGD(model.parameters(), lr=0.1),
            "step": int(value)}


def test_checkpoint_rotation(tmp_path):
    d = str(tmp_path)
    top = {0: -np.inf, 1: -np.inf, 2: -np.inf}
    for metric in (0.5, 0.7, 0.6, 0.1):
        top = checkpoints.update_top_k_performance(metric, top, d, _state(metric))
    assert top == {0: 0.7, 1: 0.6, 2: 0.5}
    for slot, metric in top.items():
        ckpt = torch.load(os.path.join(d, f"pretrain_performance_{slot}.pt"), weights_only=True)
        assert float(ckpt["state_dict"]["weight"][0, 0]) == pytest.approx(metric)
    checkpoints.maintain_ckpts(d, "pretrain_performance", 3)
    assert not os.path.exists(os.path.join(d, "pretrain_performance_0.pt"))
    assert not os.path.exists(os.path.join(d, "pretrain_performance_3.pt"))
    ckpt = torch.load(os.path.join(d, "pretrain_performance_1.pt"), weights_only=True)
    assert float(ckpt["state_dict"]["weight"][0, 0]) == pytest.approx(0.7)
    state = _state(0.0)
    checkpoints.load_checkpoint(os.path.join(d, "pretrain_performance_2.pt"), state)
    assert float(state["model"].weight[0, 0].detach()) == pytest.approx(0.6)
    assert state["step"] == 0


def test_infer_demo_runs():
    tok = HashTokenizer(vocab_size=1000, context_length=fx.CLAP_CONTEXT)
    with mock.patch.object(t_factory, "create_model", _narrow_create_model):
        out = infer_demo.main([], device="cpu", tokenizer=tok)
    assert out["audio"].shape == out["text"].shape == (2, fx.CLAP_KW["joint_embed_shape"])
    assert out["similarities"].shape == (2, 2) and np.isfinite(out["similarities"]).all()
