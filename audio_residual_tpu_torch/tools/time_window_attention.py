"""Time K2 (``fused_window_attention``) at HTSAT-tiny layer 3 and K4
(``fused_swin_block``) at HTSAT-tiny and HTSAT-base layer 0, B=32, bf16 AMP,
for the port found under each ROOT, to compare checkouts on one card:

    python3 audio_residual_tpu_torch/tools/time_window_attention.py OLD NEW NEW OLD

Each ROOT (a checkout's root directory) runs in its own process, in the
order given, and imports ``audio_residual_tpu_torch`` from there, so an
older checkout needs no copy of this script. ``ROOT@units`` runs that
checkout with the qkv + attention kernel launched one block a work unit
instead of one block an SM (a checkout whose plan has ``blocks``).

A run prints one JSON line a case: the median event time of one call and,
from one ``torch.profiler`` window over ``REPS`` calls, the device time a
call of all of its kernels and of its attention kernels (the qkv +
attention kernel ``window_attention_wgmma_kernel``; in an older checkout
the ``attention_core_kernel``, beside which its qkv GEMM ran as a
``gemm_kernel``), and the device ms a call of each kernel name. Exits
non-zero when a run fails or its trace holds no device time.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

B, WINDOW = 32, 8
REPS = 20
# (case, C, heads, windows per clip, resolution, shift, ResiDual + double FFN)
CASES = [("K2 tiny layer 3", 768, 32, 1, (8, 8), 0, False),
         ("K4 tiny layer 0 shift 0", 96, 4, 64, (64, 64), 0, True),
         ("K4 tiny layer 0 shift 4", 96, 4, 64, (64, 64), 4, True),
         ("K4 base layer 0 shift 0", 128, 4, 64, (64, 64), 0, True),
         ("K4 base layer 0 shift 4", 128, 4, 64, (64, 64), 4, True)]


def _profile(fn, reps: int) -> tuple[float, dict]:
    """(busy device ms a call, {kernel name: device ms a call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the profiler's trace holds no device time")
    names = collections.Counter()
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        names[name] += (end - start) / 1e3 / reps
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return busy / 1e3 / reps, dict(names)


def _event_ms(fn, reps: int) -> float:
    import torch

    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def run_one(spec: str) -> None:
    root, _, variant = spec.partition("@")
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import audio_residual_tpu_torch
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2

    where = Path(audio_residual_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError(f"imported the port from {where}, not from {root}")
    if variant == "units":  # one block a work unit: the non-persistent grid
        plan = k2.amp_plan

        def units_plan(*args):
            p = plan(*args)
            return dataclasses.replace(p, blocks=p.grid[0] * p.grid[1])

        k2.amp_plan = units_plan
    elif variant:
        raise ValueError(f"unknown variant {variant!r}")
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).cuda()

    bf16 = torch.bfloat16
    with torch.no_grad():
        for case, c, nh, nw, res, shift, residual in CASES:
            h = 4 * c
            flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.02),
                    t(3 * c, scale=0.02), t(c, c, scale=0.02), t(c, scale=0.02),
                    t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(h, c, scale=0.02),
                    t(h, scale=0.02), t(c, h, scale=0.02), t(c, scale=0.02),
                    t(225, nh, scale=0.02))
            x = t(B * nw, WINDOW * WINDOW, c, scale=0.5)
            if case.startswith("K2"):  # layer 3: LN1's f32 output, as split_block gives it
                args = (x, *flat[2:6], flat[12], nh, WINDOW, nw, shift, res, bf16)
                call, plain = (lambda a=args: k2.fused_window_attention(*a),
                               lambda a=args: k2.window_attention_plain(*a))
            else:  # layer 0: bf16 activations, ResiDual + the double FFN
                q, _ = np.linalg.qr(rng.standard_normal((c, c)))
                rp = (torch.from_numpy(q.astype(np.float32)).cuda(), t(c, scale=0.01),
                      t(c, scale=0.1, offset=1.0))
                args = (x.to(bf16), flat + rp, nh, WINDOW, nw, shift, res, residual, residual,
                        bf16)
                call, plain = (lambda a=args: k4.fused_swin_block(*a),
                               lambda a=args: k4.swin_block_plain(*a))
            ref = plain()
            err = float((call().float() - ref.float()).abs().max() / ref.float().abs().max())
            for _ in range(3):
                call()
            event = _event_ms(call, REPS)
            busy, names = _profile(call, REPS)
            attention = sum(v for n, v in names.items()
                            if "window_attention_wgmma" in n or "attention_core" in n)
            print(json.dumps({"root": spec, "case": case, "event_ms": event,
                              "call_device_ms": busy, "attention_device_ms": attention,
                              "max_rel_err": err,
                              "kernels": {n[:90]: round(v, 5) for n, v in
                                          sorted(names.items(), key=lambda kv: -kv[1])}}),
                  flush=True)


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
    for spec in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", spec]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
