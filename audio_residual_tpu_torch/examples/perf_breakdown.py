"""Per-stage time breakdown of the zero-shot inference path on the card.

Port of ``examples/perf_breakdown.py``. Measures each stage of the bench's
program in isolation with :func:`~audio_residual_tpu_torch.utils.profiling.
measure_seconds` (CUDA events at two loop lengths, the difference per call):

  featurize        int16 round-trip + repeatpad           (`data.py:402-506`)
  logmel_only      K1 alone on the featurized batch (a part of frontend_patch)
  frontend_patch   log-mel + bn0 + reshape_wav2img + patch embed
  layer_0..3       one Swin layer each (the kernels), via the
                   start_layer / stop_at_layer split points; the last one
                   includes the head, projection and L2 norm
  layer_3+head+sims  the last layer + head + sims argmax
  total            the full zero-shot program (bench.py's ``zero_shot``)
  total_residual   the same with a ResiDual at layer 0

Environment: ``BENCH_BATCH`` (default 128), ``BENCH_DTYPE`` (``bf16``, the
default, is the AMP mode; anything else golden f32), ``BENCH_RESIDUAL`` (a
reference-format PCA pickle for ``total_residual``; default an orthonormal
basis from a seeded QR with K = C, where the JAX script reads the reference's
ESC-50 basis). Prints one ``PERF_BREAKDOWN {json}`` line (µs/clip per stage
and shares). Measurements only: it claims nothing.

Run: ``python -m audio_residual_tpu_torch.examples.perf_breakdown``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device

N_TEXT = 50


def measure(fn, args, iters=10, reps=3) -> float:
    """µs per call of ``fn(*args)`` by ``utils/profiling.measure_seconds``."""
    from audio_residual_tpu_torch.utils.profiling import measure_seconds

    return measure_seconds(fn, args, iters=iters, reps=reps) * 1e6


def stage_residual(cfg, device) -> dict:
    """``{0: ResiDual params}`` for ``total_residual``: ``BENCH_RESIDUAL``'s
    pickle, else an orthonormal basis from a seeded QR (K = C), a small mean
    and λ near 1."""
    from audio_residual_tpu_torch.residual.module import (init_residual_params,
                                                          load_residual_params)

    path = os.environ.get("BENCH_RESIDUAL")
    if path:
        return {0: load_residual_params(path, device=device)}
    rng = np.random.default_rng(1)
    c = cfg.audio.embed_dim
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res = init_residual_params(q, rng.standard_normal(c) * 0.01, device=device)
    res["lam"] = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(device)
    return {0: res}


def main(argv=None, *, model=None, device=None) -> dict:
    """Returns the ``PERF_BREAKDOWN`` summary it prints. ``model``: a ready
    ``CLAPAudio`` (its device is the run's) in place of the seeded
    ``CLAPConfig()`` one."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    dtype = os.environ.get("BENCH_DTYPE", "bf16")

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models import clap as clap_mod
    from audio_residual_tpu_torch.ops.cuda.frontend import fused_logmel
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
    from audio_residual_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()
    if model is None:
        model = clap_mod.build_clap_audio(clap_mod.CLAPConfig(), seed=0,
                                          device=resolve_device(device))
    cfg = model.cfg
    dev = model.audio_projection[0].weight.device
    compute_dtype = torch.bfloat16 if dtype == "bf16" else None
    max_len = cfg.audio.clip_samples
    clip = max_len // 2  # ESC-50's 5 s at the model's 10 s input: repeat-padded
    n_layers = len(cfg.audio.depths)
    crops = torch.Generator().manual_seed(0)

    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((batch, clip)) * 0.1).astype(np.float32)).to(dev)
    text = torch.from_numpy(
        rng.standard_normal((N_TEXT, cfg.joint_embed_shape)).astype(np.float32)).to(dev)
    enc_kw = dict(compute_dtype=compute_dtype)

    def featurize(w):
        return featurize_batch(quantize_roundtrip(w), max_len, generator=crops)["waveform"]

    def to_tokens(w, until):
        return clap_mod.encode_audio(model, {"waveform": w}, stop_at_layer=until,
                                     **enc_kw)["tokens"]

    stages = {}
    with torch.no_grad():
        stages["featurize"] = measure(featurize, (wav,))
        featurized = featurize(wav)
        dft = "bf16" if compute_dtype is not None else None
        stages["logmel_only"] = measure(
            lambda w: fused_logmel(w, cfg.audio.frontend_config, dft_mode=dft), (featurized,))
        stages["frontend_patch"] = measure(lambda w: to_tokens(w, 0), (featurized,))
        tokens = [to_tokens(featurized, i) for i in range(n_layers)]

        for i in range(n_layers):
            until = i + 1 if i + 1 < n_layers else None
            if until is not None:
                fn = lambda t, i=i, u=until: clap_mod.encode_audio(  # noqa: E731
                    model, {"tokens": t}, start_layer=i, stop_at_layer=u, **enc_kw)["tokens"]
            else:
                fn = lambda t, i=i: clap_mod.encode_audio(  # noqa: E731
                    model, {"tokens": t}, start_layer=i, **enc_kw)["normalized"]
            stages[f"layer_{i}"] = measure(fn, (tokens[i],))

        # the last layer above includes the head (no split point after it);
        # also time it with sims + argmax on the final embedding (the JAX
        # script's key, whatever the depth)
        def head_sims(t):
            out = clap_mod.encode_audio(model, {"tokens": t}, start_layer=n_layers - 1,
                                        **enc_kw)
            return (out["normalized"].float() @ text.t()).argmax(-1)

        stages["layer_3+head+sims"] = measure(head_sims, (tokens[n_layers - 1],))

        def zero_shot(w, residual=None):
            batch_in = featurize_batch(quantize_roundtrip(w), max_len, generator=crops)
            out = clap_mod.encode_audio(model, batch_in, residual=residual, **enc_kw)
            return (out["normalized"].float() @ text.t()).argmax(-1)

        stages["total"] = measure(zero_shot, (wav,))
        residual = stage_residual(cfg, dev)
        stages["total_residual"] = measure(lambda w: zero_shot(w, residual), (wav,))

    us_per_clip = {k: round(v / batch, 2) for k, v in stages.items()}
    known = sum(
        us_per_clip[k] for k in us_per_clip
        # logmel_only is a part of frontend_patch, not a stage; total_residual
        # is the bench program's twin of total
        if k not in ("total", "total_residual", "layer_3+head+sims", "logmel_only")
    )
    summary = {
        "batch": batch,
        "dtype": dtype,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "us_per_clip": us_per_clip,
        "stage_sum_us": round(known, 2),
        "clips_per_sec_total": round(batch / stages["total"] * 1e6, 1),
        "share": {
            k: round(v / us_per_clip["total"], 3)
            for k, v in us_per_clip.items()
            if k not in ("total", "total_residual")
        },
    }
    print("PERF_BREAKDOWN " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
