"""Time K3 (``fused_residual_ffn``) at HTSAT-tiny and HTSAT-base layer 3
(B=32: 2048 rows, C = 768 and 1024) and K4 (``fused_swin_block``) at
HTSAT-tiny layer 2 (B=32: 128 windows, C = 384), for the port found under
each ROOT, to compare two checkouts on one card:

    python3 audio_residual_tpu_torch/tools/time_residual_ffn.py OLD NEW NEW OLD

Each ROOT (a checkout's root directory) runs in its own process, in the
order given, and imports ``audio_residual_tpu_torch`` from there, so an
older checkout needs no copy of this script. A run prints one JSON line a
(kernel, shape, mode), golden f32 and bf16 AMP: the median event time of one
call, and from one ``torch.profiler`` window over ``REPS`` calls the device
time a call of all the call's kernels and its kernels by name. K3's AMP lines
also carry the device time of the same function as a sequence of PyTorch
calls on the same bf16 operands (``F.layer_norm`` -> ``F.linear`` +
``F.gelu`` -> ``F.linear`` + add), a yardstick the port never calls. Exits
non-zero when a run fails or its trace holds no device time.
"""

from __future__ import annotations

import collections
import json
import statistics
import subprocess
import sys
from pathlib import Path

B = 32
REPS = 20


def _device_ms(fn, reps: int) -> tuple[float, dict]:
    """(busy device ms a call, {kernel name: device ms a call}) from one
    profiler window over ``reps`` calls."""
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
        names[name[:60]] += (end - start) / 1e3 / reps
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


def _sequence(x, a, n2s, n2b, w1, b1, w2, b2):
    """K3's function as PyTorch calls on bf16 operands."""
    import torch
    import torch.nn.functional as F

    w1b, b1b, w2b, b2b = (t.to(torch.bfloat16) for t in (w1, b1, w2, b2))

    def run():
        h = x.float() + a.float()
        z = F.layer_norm(h, (h.shape[-1],), n2s, n2b).to(torch.bfloat16)
        return h + F.linear(F.gelu(F.linear(z, w1b, b1b)), w2b, b2b)

    return run


def run_one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import audio_residual_tpu_torch
    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4

    where = Path(audio_residual_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError(f"imported the port from {where}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)

    def t(*shape, scale, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).cuda()

    def ffn_weights(c):
        return (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(4 * c, c, scale=0.02),
                t(4 * c, scale=0.02), t(c, 4 * c, scale=0.02), t(c, scale=0.02))

    def report(kernel, shape, mode, call, plain, extra=None):
        err = float((call().float() - plain().float()).abs().max())
        for _ in range(3):
            call()
        event = _event_ms(call, REPS)
        busy, names = _device_ms(call, REPS)
        print(json.dumps({"root": root, "kernel": kernel, "shape": shape, "mode": mode,
                          "event_ms": event, "call_device_ms": busy, "kernels_device_ms": names,
                          "max_abs_err": err, **(extra or {})}), flush=True)

    with torch.no_grad():
        for c in (768, 1024):
            x, a = t(B * 64, c, scale=0.5), t(B * 64, c, scale=0.1)
            weights = ffn_weights(c)
            for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
                def call(md=md):
                    return k3.fused_residual_ffn(x, a, *weights, mxu_dtype=md)

                def plain(md=md):
                    return k3.residual_ffn_plain(x, a, *weights, mxu_dtype=md)

                extra = None
                if md is not None:
                    seq = _sequence(x, a, *weights)
                    seq()
                    extra = {"sequence_device_ms": _device_ms(seq, REPS)[0]}
                report("fused_residual_ffn", f"[{B * 64}x{c}]", mode, call, plain, extra)
        c, nh, nw = 384, 16, 4
        flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.02),
                t(3 * c, scale=0.02), t(c, c, scale=0.02), t(c, scale=0.02),
                *ffn_weights(c), t(225, nh, scale=0.02))
        x = t(B * nw, 64, c, scale=0.5)
        for mode, md in (("f32", None), ("bf16", torch.bfloat16)):
            args = (x, flat, nh, 8, nw, 0, (16, 16), False, False, md)
            report("fused_swin_block", f"[{B * nw}x64x{c}]", mode,
                   lambda args=args: k4.fused_swin_block(*args),
                   lambda args=args: k4.swin_block_plain(*args))


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
