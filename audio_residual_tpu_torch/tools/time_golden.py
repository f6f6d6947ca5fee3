"""Time the golden f32 routes of K1 (``fused_logmel``), K2
(``fused_window_attention``), K3 (``fused_residual_ffn``), K4
(``fused_swin_block``) and K5 (``wide_window_attention``) at the main paths'
shapes, B=32, for the port found under each ROOT, to compare two checkouts
on one card:

    python3 audio_residual_tpu_torch/tools/time_golden.py OLD NEW NEW OLD

Each ROOT (a checkout's root directory) runs in its own process, in the
order given, and imports ``audio_residual_tpu_torch`` from there, so an
older checkout needs no copy of this script. Shapes: K1 at [32, 480000]
(HTSAT-tiny's frontend); K2 at HTSAT-tiny layer 3 (2048 rows, C = 768, 32
heads) and K5 at HTSAT-base layer 3 (C = 1024, 32 heads); K3 at HTSAT-tiny
and HTSAT-base layer 3 (2048 rows, C = 768 and 1024); K4 at HTSAT-tiny
layer 0 (131072 rows, C = 96, ResiDual and the double FFN, shift 4) and
layer 2 (8192 rows, C = 384). A
run prints one JSON line a (kernel, shape): the median event time of one
call, and from one ``torch.profiler`` window over ``REPS`` calls the device
time a call of all the call's kernels and its kernels by name, with the
largest difference from the plain version. Exits non-zero when a run fails
or its trace holds no device time.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

B = 32
REPS = 10


def run_one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import audio_residual_tpu_torch
    from audio_residual_tpu_torch.ops import frontend as fe
    from audio_residual_tpu_torch.ops.cuda import frontend as k1
    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    from time_residual_ffn import _device_ms, _event_ms

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

    def report(kernel, shape, call, plain):
        err = float((call().float() - plain().float()).abs().max())
        for _ in range(3):
            call()
        event = _event_ms(call, REPS)
        busy, names = _device_ms(call, REPS)
        print(json.dumps({"root": root, "kernel": kernel, "shape": shape, "mode": "f32",
                          "event_ms": event, "call_device_ms": busy, "kernels_device_ms": names,
                          "max_abs_err": err}), flush=True)

    with torch.no_grad():
        cfg = fe.FrontendConfig()
        wav = t(B, 480000, scale=0.1)
        report("fused_logmel", f"[{B},480000]", lambda: k1.fused_logmel(wav, cfg, "f32"),
               lambda: k1.logmel_plain(wav, cfg, "f32"))
        del wav
        for c, kernel, plain, name in ((768, k2.fused_window_attention, k2.window_attention_plain,
                                        "fused_window_attention"),
                                       (1024, k5.wide_window_attention, k5.wide_attention_plain,
                                        "wide_window_attention")):
            y = t(B, 64, c, scale=0.5)
            attn = (t(3 * c, c, scale=0.02), t(3 * c, scale=0.02), t(c, c, scale=0.02),
                    t(c, scale=0.02), t(225, 32, scale=0.02))
            args = (y, *attn, 32, 8, 1, 0, (8, 8))
            report(name, f"[{B}x64x{c}]", lambda args=args, kernel=kernel: kernel(*args),
                   lambda args=args, plain=plain: plain(*args))
        for c in (768, 1024):
            x, a = t(B * 64, c, scale=0.5), t(B * 64, c, scale=0.1)
            weights = ffn_weights(c)
            report("fused_residual_ffn", f"[{B * 64}x{c}]",
                   lambda: k3.fused_residual_ffn(x, a, *weights),
                   lambda: k3.residual_ffn_plain(x, a, *weights))
        for c, nh, nw, hw, res in ((96, 4, 64, (64, 64), True), (384, 16, 4, (16, 16), False)):
            flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.02),
                    t(3 * c, scale=0.02), t(c, c, scale=0.02), t(c, scale=0.02),
                    *ffn_weights(c), t(225, nh, scale=0.02))
            if res:
                q, _ = np.linalg.qr(rng.standard_normal((c, c)))
                flat += (torch.from_numpy(q.astype(np.float32)).cuda(), t(c, scale=0.01),
                         t(c, scale=0.1, offset=1.0))
            x = t(B * nw, 64, c, scale=0.5)
            args = (x, flat, nh, 8, nw, 4, hw, res, res, None)
            report("fused_swin_block", f"[{B * nw}x64x{c}] res={res}",
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
