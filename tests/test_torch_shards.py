"""The port's tar-shard input held against the JAX package on the CPU:
``data/shards.py`` (text selection, shard discovery, sub-sampling, the tar
reader with its WAV decoder and error handler, ``ShardedAudioText``'s
batches), ``training/main.py::build_data``'s shard branch under ``auto``
and ``webdataset``, ``main`` on shards, ``utils/check_tars.py`` and
``evaluate/eval_retrieval_main.py``.

Shards are written into ``tmp_path`` from seeds: PCM WAVs at 8 kHz (8, 16
and 32 bit, mono and stereo) with JSON captions, one FLAC, one corrupt
member and one truncated tar. Batches must be equal, bit for bit.
"""

import io
import json
import shutil
import tarfile
import unittest.mock as mock
import wave

import numpy as np
import pytest
import torch

from audio_residual_tpu.data import shards as j_shards
from audio_residual_tpu.evaluate import eval_retrieval_main as j_eval
from audio_residual_tpu.training import main as j_main
from audio_residual_tpu.training import params as j_params
from audio_residual_tpu.utils import check_tars as j_check
from audio_residual_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from audio_residual_tpu_torch.data import shards as t_shards
from audio_residual_tpu_torch.evaluate import eval_retrieval_main as t_eval
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.training import main as t_main
from audio_residual_tpu_torch.training import params as t_params
from audio_residual_tpu_torch.utils import check_tars as t_check
from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

SR = 8000
AUDIO_CFG = dict(sample_rate=SR, window_size=256, hop_size=128, mel_bins=16, fmin=10,
                 fmax=3000, clip_samples=4000)
BATCH_KEYS = ("waveform", "longer", "input_ids", "attention_mask")


def wav_bytes(samples: np.ndarray, width: int, sr: int = SR) -> bytes:
    """``samples [T, channels]`` in [-1, 1) as PCM of ``width`` bytes."""
    if width == 1:
        data = np.clip(samples * 128 + 128, 0, 255).astype(np.uint8)
    else:
        dtype = {2: np.int16, 4: np.int32}[width]
        data = (samples * np.iinfo(dtype).max).astype(dtype)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return buf.getvalue()


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shard(path, n: int, seed: int, *, lengths=(2000, 6000), widths=(2,), channels=(1,),
                caption=lambda i: {"text": f"sound number {i}"}, sr: int = SR) -> None:
    """``n`` samples of random length in ``lengths`` samples, widths and
    channel counts taken in turn, each with a JSON caption."""
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            t = int(rng.integers(*lengths))
            c = channels[i % len(channels)]
            _add(tf, f"s{seed}_{i:03d}.wav",
                 wav_bytes(rng.uniform(-0.5, 0.5, (t, c)), widths[i % len(widths)], sr))
            _add(tf, f"s{seed}_{i:03d}.json", json.dumps(caption(i)).encode())


def write_dataset(root, name: str, split: str, shards: int, per_shard: int, seed: int,
                  sizes: bool = True, **kw) -> None:
    d = root / name / split
    d.mkdir(parents=True)
    for s in range(shards):
        write_shard(str(d / f"{s:06d}.tar"), per_shard, seed + s, **kw)
    if sizes:
        (d / "sizes.json").write_text(json.dumps({f"{s:06d}.tar": per_shard
                                                  for s in range(shards)}))


def _equal_batches(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        for k in BATCH_KEYS:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("raw", [
    {"text": "raw", "text_augment_all": ["a1", "a2"], "text_augment_t5": "t5"},
    {"text": "raw", "text_augment_all": ["a1"], "text_augment_t5": None},
    {"text": "raw"}, {"caption": "cap"}, {"text": ""}])
def test_select_text_equals_jax(raw):
    for mode in (None, "none", "all", "augment_only"):
        assert t_shards.select_text(raw, mode) == j_shards.select_text(raw, mode)
        assert (t_shards.select_text(raw, mode, text_field="caption")
                == j_shards.select_text(raw, mode, text_field="caption"))
    with pytest.raises(NotImplementedError):
        t_shards.select_text(raw, "bogus")


def test_resolve_tar_paths_and_sample_prop_equal_jax(tmp_path):
    """The ``sizes.json`` layout, a split without it (listing, sizes -1), a
    missing split; sub-sampling at several proportions and seeds."""
    write_dataset(tmp_path, "a", "train", 5, 1, 0)
    write_dataset(tmp_path, "b", "train", 2, 1, 9, sizes=False)
    (tmp_path / "b" / "train" / "notes.txt").write_text("x")
    for names in (["a"], ["b"], ["a", "b"], ["a", "missing"]):
        want = j_shards.resolve_tar_paths(str(tmp_path), names, "train")
        assert t_shards.resolve_tar_paths(str(tmp_path), names, "train") == want
    paths, sizes = t_shards.resolve_tar_paths(str(tmp_path), ["a", "b"], "train")
    for prop, seed in ((1.0, 0), (0.5, 0), (0.5, 3), (0.1, 1)):
        got, want = (m.sample_prop(paths, sizes, prop, seed) for m in (t_shards, j_shards))
        assert [str(p) for p in got[0]] == [str(p) for p in want[0]] and got[1] == want[1]


def test_iter_tar_samples_equals_jax(tmp_path):
    """8/16/32-bit mono and stereo WAVs, a JSON-only sample, a FLAC (which
    raises for want of soundfile) and a corrupt WAV, through the handler:
    the same samples, bit for bit, and the same errors."""
    path = str(tmp_path / "mixed.tar")
    rng = np.random.default_rng(3)
    with tarfile.open(path, "w") as tf:
        for i, (width, ch) in enumerate([(1, 1), (2, 2), (4, 1), (4, 2), (2, 1)]):
            _add(tf, f"k{i}.wav", wav_bytes(rng.uniform(-0.9, 0.9, (500 + 7 * i, ch)), width))
            _add(tf, f"k{i}.json", json.dumps({"text": f"t{i}"}).encode())
        _add(tf, "k5.json", b'{"text": "no audio"}')
        _add(tf, "k6.flac", b"fLaC not really")
        _add(tf, "k7.wav", b"RIFF broken")
        _add(tf, "k8.wav", wav_bytes(rng.uniform(-0.5, 0.5, (300, 1)), 2))
    runs = {}
    for name, mod in (("port", t_shards), ("jax", j_shards)):
        errors = []
        samples = list(mod.iter_tar_samples(path, handler=lambda e: errors.append(e) or True))
        runs[name] = samples, [type(e) for e in errors]
    (got, got_err), (want, want_err) = runs["port"], runs["jax"]
    assert got_err == want_err and len(got_err) == 2 and RuntimeError in got_err
    assert [s["__key__"] for s in got] == [s["__key__"] for s in want] == [
        "k0", "k1", "k2", "k3", "k4", "k8"]
    for g, w in zip(got, want):
        assert g.get("json") == w.get("json") and g["audio"].dtype == w["audio"].dtype
        np.testing.assert_array_equal(g["audio"], w["audio"])
    with pytest.raises(RuntimeError, match="soundfile"):
        t_shards._decode_audio("x.flac", b"fLaC")


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    """Two datasets, train and valid splits; ``d1``'s captions carry the
    augmented texts (a list under ``text_augment_all``)."""
    root = tmp_path_factory.mktemp("shards")
    aug = lambda i: {"text": f"raw {i}", "text_augment_all": [f"all {i}", f"alt {i}"],  # noqa
                     "text_augment_t5": f"t5 {i}" if i % 3 else None}
    write_dataset(root, "d0", "train", 3, 3, 0, widths=(2, 4, 1), channels=(1, 2))
    write_dataset(root, "d1", "train", 2, 3, 10, caption=aug)
    write_dataset(root, "d0", "valid", 1, 4, 20)
    write_dataset(root, "d1", "test", 1, 2, 30)
    return root


PIPES = {
    "pad": dict(data_filling="pad"),
    "repeatpad-2nodes": dict(data_filling="repeatpad", num_nodes=2),
    "repeat-aug-all": dict(data_filling="repeat", text_augment_selection="all"),
    "augment-only-per-epoch": dict(text_augment_selection="augment_only", batches_per_epoch=2,
                                   num_nodes=2),
    "fusion": dict(data_truncating="fusion", data_filling="repeatpad", batches_per_epoch=2),
}


@pytest.mark.parametrize("name", list(PIPES))
def test_sharded_epochs_equal_jax(name, shard_root):
    """``ShardedAudioText.epoch(e)`` for e = 0, 1 (each rank of two nodes
    where set): waveform, longer, token ids and texts equal to JAX's. The
    fusion pipe also carries ``mel_fusion`` (K1 on the CPU here), and its
    crops stay in step with JAX's after the chunk draws."""
    kw = dict(PIPES[name])
    paths, _ = t_shards.resolve_tar_paths(str(shard_root), ["d0", "d1"], "train")
    common = dict(tar_paths=paths, batch_size=3, max_len=AUDIO_CFG["clip_samples"],
                  audio_cfg=AUDIO_CFG, seed=5)
    for rank in range(kw.get("num_nodes", 1)):
        kw["node_rank"] = rank
        port = t_shards.ShardedAudioText(tokenize=HashTokenizer(context_length=12), device="cpu",
                                         **common, **kw)
        ref = j_shards.ShardedAudioText(tokenize=JHashTokenizer(context_length=12), **common,
                                        **kw)
        for epoch in (0, 1):
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            _equal_batches(got, want)
            if name == "fusion":
                assert all(b["mel_fusion"].shape == (len(b["text"]), 4, 32, 16) for b in got)
                assert any(b["longer"].any() for b in got)


def _args(module, root, dataset_type, *extra):
    return module.parse_args(
        ["--datasetpath", str(root), "--datasetnames", "d0", "d1", "--batch-size", "2",
         "--seed", "3", *(["--dataset-type", dataset_type] if dataset_type else []), *extra])


@pytest.mark.parametrize("dataset_type,extra", [
    (None, ()),
    ("webdataset", ("--datasetinfos", "train", "--train-num-samples", "6", "--val-num-samples",
                    "2", "--exclude-eval-dataset", "d1", "--data-filling", "repeatpad")),
    ("auto", ("--full-train-dataset", "d1", "--dataset-proportion", "0.5",
              "--text-augment-selection", "all")),
])
def test_build_data_equals_jax(dataset_type, extra, shard_root, tmp_path):
    """The shard branch of ``build_data`` (the default ``auto`` and
    ``webdataset``) with its flags: the same total, train batches of two
    epochs and validation batches as the JAX package's."""
    model_cfg = {"audio_cfg": AUDIO_CFG}
    targs = _args(t_params, shard_root, dataset_type, *extra)
    jargs = _args(j_params, shard_root, dataset_type, *extra)
    got = t_main.build_data(targs, model_cfg, HashTokenizer(context_length=12), str(tmp_path),
                            device="cpu")
    want = j_main.build_data(jargs, model_cfg, JHashTokenizer(context_length=12))
    assert got[1] == want[1]
    for epoch in (0, 1):
        _equal_batches(list(got[0](epoch)), list(want[0](epoch)))
    assert (got[2] is None) == (want[2] is None)
    if got[2] is not None:
        _equal_batches(list(got[2]()), list(want[2]()))
    assert targs.val_dataset_names == jargs.val_dataset_names


CLIP = fx.AUDIO_KW["clip_samples"]


def _narrow_create_model(*a, device=None, seed=0, **k):
    cfg = fx.port_clap_config("roberta")
    model = t_clap.build_clap(cfg, seed=seed, device=device)
    model_cfg = t_factory.get_model_config("HTSAT-tiny")
    return model, cfg, {**model_cfg, "audio_cfg": {**model_cfg["audio_cfg"],
                                                   "clip_samples": CLIP}}


@pytest.fixture(scope="module")
def narrow_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("narrow")
    write_dataset(root, "clotho", "train", 2, 2, 40, lengths=(20000, 30000), sr=48000)
    write_dataset(root, "clotho", "valid", 1, 2, 50, lengths=(20000, 30000), sr=48000)
    return root


@pytest.mark.parametrize("dataset_type", [None, "webdataset"])
def test_main_trains_on_shards(dataset_type, narrow_shards, tmp_path):
    """``main`` with the default ``--dataset-type`` and with ``webdataset``
    on seeded shards: 2 steps at a narrow registered config, finite losses,
    validation metrics and a checkpoint; then ``eval_retrieval_main`` on
    the valid split with that checkpoint, metrics in [0, 1]."""
    tok = HashTokenizer(vocab_size=1000, context_length=fx.CLAP_CONTEXT)
    argv = ["--datasetpath", str(narrow_shards), "--datasetnames", "clotho", "--batch-size",
            "2", "--epochs", "1", "--precision", "fp32", "--lr", "1e-4", "--warmup", "1",
            "--logs", str(tmp_path), "--name", "run", "--seed", "7", "--log-local",
            *(["--dataset-type", dataset_type] if dataset_type else [])]
    with mock.patch.object(t_factory, "create_model", _narrow_create_model):
        out = t_main.main(argv, device="cpu", tokenizer=tok)
        assert out["steps"] == 2 and np.isfinite(out["metrics"]["all/cumulative_loss"])
        ckpt = tmp_path / "run" / "checkpoints" / "epoch_0.pt"
        assert ckpt.exists()
        if dataset_type:
            return
        res = t_eval.main(["--datasetpath", str(narrow_shards), "--datasetnames", "clotho",
                           "--split", "valid", "--batch-size", "2", "--pretrained", str(ckpt),
                           "--device", "cpu"], tokenizer=tok)
    (m,) = res["history"]
    assert m["ckpt"] == str(ckpt) and res["best"]["best"] is m
    scores = [v for k, v in m.items() if "R@" in k or "mAP" in k]
    assert len(scores) == 8 and all(0.0 <= v <= 1.0 for v in scores)


class _Module:
    """A stand-in for both packages' ``CLAPModule`` in ``eval_retrieval_main``."""

    def __init__(self, amodel="HTSAT-tiny", tmodel="roberta", **_):
        self.tokenize = HashTokenizer(context_length=12)
        self.cfg = type("C", (), {"audio": type("A", (), {"clip_samples": 4000})})
        self.model_cfg = {"audio_cfg": AUDIO_CFG}
        self.device = torch.device("cpu")
        self.loaded = []

    def load_ckpt(self, ckpt):
        self.loaded.append(ckpt)


def test_eval_retrieval_main_equals_jax(shard_root, tmp_path):
    """``read_params_txt``, and ``main``'s shard reading and checkpoint
    sweep against JAX's (the metric stubbed: it records the batches and
    scores each checkpoint by its epoch), so the same batches reach the
    metric and the same checkpoint is the best."""
    params = tmp_path / "params.txt"
    params.write_text("amodel: HTSAT-base\ntmodel: roberta\nlr: 0.001\nnot a pair\n")
    assert t_eval.read_params_txt(str(params)) == j_eval.read_params_txt(str(params))
    for i in (0, 3, 1):
        (tmp_path / f"epoch_{i}.pt").write_bytes(b"")
    argv = ["--datasetpath", str(shard_root), "--datasetnames", "d0", "d1", "--split", "valid",
            "--batch-size", "2", "--ckpt-dir", str(tmp_path), "--params-txt", str(params),
            "--metric", "score"]
    runs = {}
    for name, mod in (("port", t_eval), ("jax", j_eval)):
        seen = []

        def metric(module, batches):
            seen.append([(np.asarray(w).copy(), list(t)) for w, t in batches])
            return {"score": float(module.loaded[-1].rsplit("_", 1)[1][:-3])}

        with mock.patch.object(mod, "CLAPModule", _Module), \
                mock.patch.object(mod, "evaluate_retrieval", metric):
            runs[name] = mod.main(argv), seen
    (got, got_seen), (want, want_seen) = runs["port"], runs["jax"]
    assert got["best"] == want["best"] and got["best"]["value"] == 3.0
    assert [m["ckpt"] for m in got["history"]] == [m["ckpt"] for m in want["history"]]
    for g, w in zip(got_seen, want_seen):
        assert len(g) == len(w) == 2
        for (gw, gt), (ww, wt) in zip(g, w):
            assert gt == wt
            np.testing.assert_array_equal(gw, ww)


def test_check_tars_equals_jax(tmp_path, capsys):
    """A good shard, a truncated one and an empty one: the same report, the
    same files moved aside and the same ``sizes.json``."""
    src = tmp_path / "src"
    src.mkdir()
    write_shard(str(src / "a.tar"), 3, 0)
    write_shard(str(src / "b.tar"), 3, 1)
    data = (src / "b.tar").read_bytes()
    (src / "b.tar").write_bytes(data[: len(data) // 2 + 100])
    with tarfile.open(src / "c.tar", "w"):
        pass
    reports = {}
    for name, mod in (("port", t_check), ("jax", j_check)):
        d = tmp_path / name
        shutil.copytree(src, d)
        reports[name] = mod.check_tars(str(d))
        reports[name + "/sizes"] = json.loads((d / "sizes.json").read_text())
        reports[name + "/moved"] = sorted(p.name for p in (tmp_path / f"{name}_invalid").iterdir())
    for key in ("", "/sizes", "/moved"):
        assert reports["port" + key] == reports["jax" + key], key
    assert reports["port"]["bad"] == ["b.tar", "c.tar"] and reports["port"]["ok"] == {"a.tar": 3}
