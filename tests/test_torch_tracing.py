"""The port's spans (``utils/profiling.py::annotate``) on the CPU.

Under a ``torch.profiler`` the zero-shot path, the λ step and ``run_pca``
leave named ``user_annotation`` ranges in the Chrome trace, nested as the
layers nest: ``encode_audio`` > ``htsat.layer{i}`` > ``htsat.merge{i}`` and
``kernel.<wrapper>``; ``train.forward`` / ``train.backward``, with
``recompute.<wrapper>`` inside the autograd engine's ops on the backward's
thread; ``pca.encode`` / ``pca.update`` a batch and one ``pca.finalize``.
While no profiler records, a span site builds no ``record_function`` and
formats no name, and a profiler changes no output bit.

The model is a seeded HTSAT of three layers of depth 2 and window 4 on
16x16 patches: layers 0 and 1 run the block kernel (K4), layer 2 (one
window an image) the split plan (K2 + K3).
"""

from __future__ import annotations

import json
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import audio_residual_tpu_torch.utils.profiling as t_prof
from audio_residual_tpu_torch.data.featurize import featurize_batch
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.ops.cuda import swin_block as k4
from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
from audio_residual_tpu_torch.residual.analyze import run_pca
from audio_residual_tpu_torch.training import train_residual as tr

AUDIO = t_htsat.HTSATConfig(spec_size=64, mel_bins=16, embed_dim=16, depths=(2, 2, 2),
                            num_heads=(2, 2, 4), window_size=4, clip_samples=9600,
                            num_classes=10)
CFG = t_clap.CLAPConfig(embed_dim=64, joint_embed_shape=16, audio=AUDIO)
MODES = {"golden": None, "amp": torch.bfloat16}
B, CLASSES = 2, 3
BACKWARD_OP = "autograd::engine::evaluate_function"


@pytest.fixture(scope="module")
def model():
    return t_clap.build_clap_audio(CFG, seed=0, device="cpu")


def _residual(requires_grad: bool = False) -> dict:
    g = torch.Generator().manual_seed(1)
    c = AUDIO.embed_dim
    basis, _ = torch.linalg.qr(torch.randn(c, c, generator=g))
    lam = (1 + 0.1 * torch.randn(c, generator=g)).requires_grad_(requires_grad)
    return {0: {"basis": basis, "mean": 0.01 * torch.randn(c, generator=g), "lam": lam}}


def _clips(n: int = B) -> torch.Tensor:
    g = torch.Generator().manual_seed(2)
    return 0.1 * torch.randn(n, AUDIO.clip_samples // 2, generator=g)


def _embed(model, mode: str) -> dict:
    """The zero-shot path: quantize -> featurize -> ``encode_audio``."""
    batch = featurize_batch(quantize_roundtrip(_clips()), AUDIO.clip_samples)
    return t_clap.encode_audio(model, batch, residual=_residual(), compute_dtype=MODES[mode])


def _lambda_step(model):
    """Two λ steps on cached images: ``(losses, λ after them)``."""
    wav = quantize_roundtrip(_clips())
    labels = torch.tensor([0, 2])
    (image, _), = tr.cache_prefix_images(model, [(wav, labels)], max_len=AUDIO.clip_samples)
    residual = _residual()
    lam = {0: residual[0]["lam"].clone().requires_grad_(True)}
    frozen = {0: {"basis": residual[0]["basis"], "mean": residual[0]["mean"]}}
    text = torch.nn.functional.normalize(
        torch.randn(CLASSES, CFG.joint_embed_shape, generator=torch.Generator().manual_seed(3)),
        dim=-1)
    step, _ = tr.make_zero_shot_step(model, text, frozen, tr.adam(lam, 0.01),
                                     max_len=AUDIO.clip_samples, image_input=True)
    losses = [step(lam, image, labels)[0] for _ in range(2)]
    return torch.stack(losses), lam[0].detach()


def _pca(model, batches: int = 3) -> dict:
    def encode(wav):
        return t_clap.encode_audio(model, featurize_batch(quantize_roundtrip(wav),
                                                          AUDIO.clip_samples),
                                   taps=("attention",))

    clips = _clips(B * batches)
    return run_pca(encode, [clips[i:i + B] for i in range(0, len(clips), B)],
                   num_layers=AUDIO.num_layers, num_heads=AUDIO.num_heads,
                   window=AUDIO.window_size, device="cpu", n_components=4)


def _on_the_card_route(monkeypatch):
    """Route K4 through its autograd entry, as the wrapper does for a CUDA
    tensor that requires grad (on the CPU it runs the plain version), so
    the backward runs :class:`Recompute`."""
    def routed(x, flat_params, *args):
        return k4.swin_block_autograd(x, flat_params, *args)

    monkeypatch.setattr(t_htsat, "fused_swin_block", routed)


def _traced(fn, tmp_path):
    """``fn()`` under a CPU profiler: ``(result, spans, cpu ops)``, each span
    and op ``(name, tid, start, end)`` from the Chrome trace."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]

    def ranges(cat):
        return [(e["name"], e["tid"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                for e in events if e.get("cat") == cat]

    return out, ranges("user_annotation"), ranges("cpu_op")


def _inside(inner, outers) -> bool:
    _, tid, s, e = inner
    return any(o[1] == tid and o[2] <= s and e <= o[3] for o in outers)


def _named(spans, prefix):
    return [s for s in spans if s[0].startswith(prefix)]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_encode_audio_spans_nest_as_the_layers(model, mode, tmp_path):
    _, spans, _ = _traced(lambda: _embed(model, mode), tmp_path)
    names = {s[0] for s in spans}
    layers = AUDIO.num_layers
    assert {"quantize", "featurize", "encode_audio", "htsat.frontend", "htsat.patch_embed",
            "htsat.head", "kernel.fused_logmel", "kernel.fused_swin_block",
            "kernel.fused_window_attention", "kernel.fused_residual_ffn",
            *(f"htsat.layer{i}" for i in range(layers)),
            *(f"htsat.merge{i}" for i in range(layers - 1))} <= names
    assert "htsat.merge2" not in names  # the last layer has no PatchMerging
    encode = _named(spans, "encode_audio")
    assert len(encode) == 1
    for s in _named(spans, "htsat."):
        assert _inside(s, encode), s
    for i in range(layers - 1):
        assert _inside(_named(spans, f"htsat.merge{i}")[0], _named(spans, f"htsat.layer{i}"))
    blocks = [s for s in _named(spans, "kernel.") if s[0] != "kernel.fused_logmel"]
    assert len(blocks) == 2 + 2 + 2 * 2  # K4 in layers 0-1, K2 + K3 in layer 2
    for s in blocks:
        assert _inside(s, _named(spans, "htsat.layer")), s
    assert _inside(_named(spans, "kernel.fused_logmel")[0], _named(spans, "htsat.frontend"))
    assert not _inside(_named(spans, "quantize")[0], encode)


def test_lambda_step_spans_and_recompute_on_the_backward_thread(model, monkeypatch, tmp_path):
    _on_the_card_route(monkeypatch)
    _, spans, ops = _traced(lambda: _lambda_step(model), tmp_path)
    forward, backward = _named(spans, "train.forward"), _named(spans, "train.backward")
    assert len(forward) == len(backward) == 2
    assert {s[1] for s in forward} == {s[1] for s in backward}
    recompute = _named(spans, "recompute.")
    # two K4 blocks at layer 0 (λ's layer) and two at layer 1, each step
    assert [s[0] for s in recompute] == ["recompute.fused_swin_block"] * 8
    engine = [o for o in ops if o[0].startswith(BACKWARD_OP)]
    for s in recompute:
        assert _inside(s, engine), s
        assert not _inside(s, forward)


def test_run_pca_spans_a_batch_and_one_finalize(model, tmp_path):
    _, spans, _ = _traced(lambda: _pca(model, batches=3), tmp_path)
    counts = {n: len(_named(spans, n)) for n in ("pca.encode", "pca.update", "pca.finalize")}
    assert counts == {"pca.encode": 3, "pca.update": 3, "pca.finalize": 1}
    encode = _named(spans, "encode_audio")
    assert len(encode) == 3 and all(_inside(s, _named(spans, "pca.encode")) for s in encode)


PATHS = {"embed_golden": lambda m: _embed(m, "golden")["normalized"],
         "embed_amp": lambda m: _embed(m, "amp")["normalized"],
         "lambda": _lambda_step,
         "pca": lambda m: [torch.as_tensor(r["explained_variance"])
                           for _, r in sorted(_pca(m, 2).items())]}


def _flat(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


class _Refusing:
    """``torch.autograd.profiler`` as ``annotate`` sees it, but its
    ``record_function`` raises (PyTorch's own sites, such as the
    optimizer's, still build theirs)."""

    @property
    def _is_profiler_enabled(self) -> bool:
        return torch.autograd.profiler._is_profiler_enabled

    @staticmethod
    def record_function(name):
        raise AssertionError(f"record_function({name!r}) built by a span site")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_record_function_without_a_profiler(model, path, monkeypatch):
    if path == "lambda":
        _on_the_card_route(monkeypatch)

    monkeypatch.setattr(t_prof, "_autograd_profiler", _Refusing())
    PATHS[path](model)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function"):
            t_prof.annotate("encode_audio")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_bitwise_equal_under_a_profiler(model, path, monkeypatch):
    if path == "lambda":
        _on_the_card_route(monkeypatch)
    plain = _flat(PATHS[path](model))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _flat(PATHS[path](model))
    assert len(plain) == len(traced) > 0
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


class _Unformattable:
    def __format__(self, spec):
        raise AssertionError("a span name was formatted with no profiler recording")


@pytest.mark.parametrize("index", [None, _Unformattable()], ids=["name", "indexed"])
def test_a_span_site_off_is_one_shared_no_op(index):
    assert not torch.autograd.profiler._is_profiler_enabled
    ctx = t_prof.annotate("htsat.layer", index)
    assert ctx is t_prof.annotate("kernel.gemm")
    with ctx:
        pass


@pytest.mark.parametrize("flagged", [True, False], ids=["flagged", "named"])
def test_device_events_keep_kernels_and_drop_the_spans(flagged):
    """A span recorded with CUDA activity also comes back as a device event
    named as the span, with or without the annotation flag set."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(name, device, annotation=False):
        return types.SimpleNamespace(name=name, device_type=device,
                                     is_user_annotation=annotation)

    prof = types.SimpleNamespace(events=lambda: [
        event("kernel.gemm", cpu, True), event("aten::mm", cpu),
        event("kernel.gemm", cuda, flagged), event("gemm_kernel<bf16>", cuda),
        event("Memcpy DtoH", cuda)])
    assert [e.name for e in t_prof.device_events(prof)] == ["gemm_kernel<bf16>", "Memcpy DtoH"]

