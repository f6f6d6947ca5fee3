"""Time the main paths' forwards and the λ-training step's parts for the
port found under each ROOT, to compare two checkouts on one card:

    python3 audio_residual_tpu_torch/tools/time_forward.py OLD NEW NEW OLD

Each ROOT (a checkout's root directory) runs in its own process, in the
order given, and imports ``audio_residual_tpu_torch`` from there, so an
older checkout needs no copy of this script. The programs are
``chip_smoke.py``'s phases 3, 3b and 5 at B=32 on seeded weights and
inputs: the ESC-50 zero-shot forward (int16 round-trip, featurize,
``encode_audio`` with a ResiDual at layer 0, K = C) through HTSAT-tiny and
HTSAT-base, golden f32 and bf16 AMP; and on HTSAT-tiny one image-cached
λ-training step, split by CUDA events into forward, backward and Adam. A
run prints one JSON line a (program, mode): host-clock ms (forwards) or
CUDA-event ms (step parts), medians of ``REPS`` after one warm-up, and the
device busy ms of one more forward from one ``torch.profiler`` window.
Exits non-zero when a run fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

B, CLIP, N_CLASSES = 32, 240000, 50
REPS = 7


def _busy_ms(fn) -> float | None:
    """Device busy ms (the union of kernel intervals) of one ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_residual_tpu_torch.utils.profiling import device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    if not spans:
        return None
    busy, start, end = 0.0, *spans[0]
    for s, e in spans:
        if s > end:
            busy += end - start
            start = s
        end = max(end, e)
    return (busy + end - start) / 1e3


def run_one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import audio_residual_tpu_torch
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models.clap import CLAPConfig, build_clap_audio, encode_audio
    from audio_residual_tpu_torch.models.factory import create_audio_model
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
    from audio_residual_tpu_torch.residual.module import init_residual_params
    from audio_residual_tpu_torch.training import train_residual as tr

    where = Path(audio_residual_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError(f"imported the port from {where}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def inputs(c):
        rng = np.random.default_rng(1)
        q, _ = np.linalg.qr(rng.standard_normal((c, c)))
        res = init_residual_params(q, rng.standard_normal(c) * 0.01, device=dev)
        res["lam"] = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(np.float32)).to(dev)
        text = np.random.default_rng(7).standard_normal((N_CLASSES, 512)).astype(np.float32)
        text = torch.from_numpy(text).to(dev)
        wav = np.random.default_rng(123).standard_normal((B, CLIP)).astype(np.float32) * 0.1
        return {0: res}, text / text.norm(dim=-1, keepdim=True), torch.from_numpy(wav).to(dev)

    def report(**kv):
        print(json.dumps({"root": root, **kv}), flush=True)

    models = (("tiny", lambda: (build_clap_audio(CLAPConfig(), seed=0, device=dev), CLAPConfig())),
              ("base", lambda: create_audio_model("HTSAT-base", seed=0, device=dev)[:2]))
    for name, make in models:
        model, cfg = make()
        residual, text, wav = inputs(cfg.audio.embed_dim)
        for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
            def forward():
                with torch.no_grad():
                    batch = featurize_batch(quantize_roundtrip(wav), cfg.audio.clip_samples)
                    out = encode_audio(model, batch, residual=residual, compute_dtype=dt)
                    return (out["normalized"] @ text[:, : cfg.joint_embed_shape].t()).argmax(-1)

            forward()
            walls = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            report(program=f"{name} zero-shot forward", mode=mode,
                   host_ms=statistics.median(walls), busy_ms=_busy_ms(forward))
        if name != "tiny":
            continue
        # one image-cached λ-training step, as chip_smoke.py phase 5 runs it
        rng = np.random.default_rng(11)
        labels = torch.from_numpy(rng.integers(0, N_CLASSES, B)).to(dev)
        clips = torch.from_numpy((0.1 * rng.standard_normal((B, CLIP))).astype(np.float32)).to(dev)
        x, y = tr.cache_prefix_images(model, [(clips, labels)],
                                      max_len=cfg.audio.clip_samples)[0]
        for mode, dt in (("f32", None), ("bf16", torch.bfloat16)):
            lam, frozen = tr._split_residual(residual)
            optimizer = tr.adam(lam, 0.01)
            _, loss_fn = tr.make_zero_shot_step(model, text[:, : cfg.joint_embed_shape], frozen,
                                                optimizer, max_len=cfg.audio.clip_samples,
                                                compute_dtype=dt, image_input=True)
            out = {}

            def fwd():
                optimizer.zero_grad(set_to_none=True)
                out["loss"] = loss_fn(lam, x, y)[0]

            parts = []
            for i in range(REPS + 1):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                fwd()
                ev[1].record()
                out["loss"].backward()
                ev[2].record()
                optimizer.step()
                ev[3].record()
                ev[3].synchronize()
                if i:
                    parts.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
            fwd_ms, bwd_ms, opt_ms = (statistics.median(p[i] for p in parts) for i in range(3))
            report(program="tiny image-cached λ-step", mode=mode, forward_ms=fwd_ms,
                   backward_ms=bwd_ms, optimizer_ms=opt_ms,
                   forward_busy_ms=_busy_ms(fwd))


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        run_one(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
