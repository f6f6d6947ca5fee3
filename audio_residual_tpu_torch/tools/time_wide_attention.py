"""Time K5 (``wide_window_attention``) at HTSAT-base layer 3, B=32, for the
port found under each ROOT, to compare two checkouts on one card:

    python3 audio_residual_tpu_torch/tools/time_wide_attention.py OLD NEW NEW OLD

Each ROOT (a checkout's root directory) runs in its own process, in the
order given, and imports ``audio_residual_tpu_torch`` from there, so an
older checkout needs no copy of this script. A run prints one JSON line a
mode, golden f32 and bf16 AMP: the median event time of one call, and from
one ``torch.profiler`` window over ``REPS`` calls the device time a call of
the qkv + attention launch where a route has one (the kernels named
``wide_*``, and under AMP from the checkout that moved it onto the kernel K2
and K4 share, ``window_attention_wgmma_*``; the golden route that runs K2's
sequence has none: its qkv product and attention core show by name), of
all of the call's kernels, and of each kernel by name.
Exits non-zero when a run fails or its trace holds no device time.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

B, WINDOW, C, NH = 32, 8, 1024, 32
REPS = 20


def _device_ms(fn, reps: int) -> tuple[float, float, dict]:
    """(the qkv + attention launch, whole call, {kernel: ms}) device ms a
    call, from one profiler window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audio_residual_tpu_torch.utils.profiling import device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device_events(prof))
    if not spans:
        raise RuntimeError("the profiler's trace holds no device time")
    launch_a = sum(end - start for start, end, name in spans
                   if "wide_" in name or "window_attention_wgmma" in name)
    names: dict = {}
    for start, end, name in spans:
        names[name[:90]] = names.get(name[:90], 0.0) + (end - start) / 1e3 / reps
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, _ in spans:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return launch_a / 1e3 / reps, busy / 1e3 / reps, names


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


def run_one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import audio_residual_tpu_torch
    from audio_residual_tpu_torch.ops.cuda import wide_attention as k5

    where = Path(audio_residual_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError(f"imported the port from {where}, not from {root}")
    rng = np.random.default_rng(0)

    def t(*shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).cuda()

    weights = (t(3 * C, C, scale=0.02), t(3 * C, scale=0.02), t(C, C, scale=0.02),
               t(C, scale=0.02), t((2 * WINDOW - 1) ** 2, NH, scale=0.02))
    x = t(B, WINDOW * WINDOW, C, scale=0.5)
    with torch.no_grad():
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            args = (x, *weights, NH, WINDOW, 1, 0, (WINDOW, WINDOW), md)

            def call(args=args):
                return k5.wide_window_attention(*args)

            err = float((call().float() - k5.wide_attention_plain(*args).float()).abs().max())
            for _ in range(3):
                call()
            event = _event_ms(call, REPS)
            launch_a, device, names = _device_ms(call, REPS)
            print(json.dumps({"root": root, "mode": mode, "event_ms": event,
                              "launch_a_device_ms": launch_a, "call_device_ms": device,
                              "kernels_device_ms": names, "max_abs_err": err}), flush=True)


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
