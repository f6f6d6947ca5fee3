"""Whether the AMP routes of two checkouts give the same bits on one card:

    python3 audio_residual_tpu_torch/tools/amp_bits.py OLD NEW

Each ROOT (a checkout's root directory) runs in its own process and imports
``audio_residual_tpu_torch`` from there, so an older checkout needs no copy
of this script. A run calls every kernel's AMP route (``mxu_dtype`` bf16,
K1 ``dft_mode="bf16"``) and the bf16 GEMM on inputs made from one seed, at
main-path widths with B=2 (K1 at [2, 480000]; K4 at HTSAT-tiny layers 0 and
2, shift 4, without ResiDual and with it and the double FFN; K2 and K3 at
HTSAT-tiny layer 3; K5 and K3 at HTSAT-base layer 3, K3 without and with
ResiDual), and prints one JSON line of a SHA-256 of each output's bytes,
named with ``res=True`` where a ResiDual is on (its two products are f32 in
both modes, so a change of the golden GEMM shows there). Exits non-zero when
a run fails or when two roots' digests differ.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

B = 2


def run_one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    import audio_residual_tpu_torch
    from audio_residual_tpu_torch.ops import frontend as fe
    from audio_residual_tpu_torch.ops.cuda import frontend as k1
    from audio_residual_tpu_torch.ops.cuda import gemm as kg
    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
    from audio_residual_tpu_torch.ops.cuda import swin_block as k4
    from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
    from audio_residual_tpu_torch.ops.cuda import window_attention as k2

    where = Path(audio_residual_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in where.parents:
        raise RuntimeError(f"imported the port from {where}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def t(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).cuda()

    def block(c, nh):
        flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.02),
                t(3 * c, scale=0.02), t(c, c, scale=0.02), t(c, scale=0.02),
                t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(4 * c, c, scale=0.02),
                t(4 * c, scale=0.02), t(c, 4 * c, scale=0.02), t(c, scale=0.02),
                t(225, nh, scale=0.02))
        q, _ = np.linalg.qr(rng.standard_normal((c, c)))
        res = (torch.from_numpy(q.astype(np.float32)).cuda(), t(c, scale=0.01),
               t(c, scale=0.1, offset=1.0))
        return flat, res

    digests = {}

    def record(name, out):
        torch.cuda.synchronize()
        data = out.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        digests[name] = hashlib.sha256(data).hexdigest()

    with torch.no_grad():
        wav = t(B, 480000, scale=0.1)
        record("fused_logmel", k1.fused_logmel(wav, fe.FrontendConfig(), "bf16"))
        for c, nh, nw, hw in ((96, 4, 64, (64, 64)), (384, 16, 4, (16, 16))):
            flat, res = block(c, nh)
            x = t(B * nw, 64, c, scale=0.5).to(bf16)
            record(f"fused_swin_block C={c} res=True", k4.fused_swin_block(
                x, flat + res, nh, 8, nw, 4, hw, True, True, bf16))
            record(f"fused_swin_block C={c} res=False", k4.fused_swin_block(
                x, flat, nh, 8, nw, 4, hw, False, False, bf16))
        for c, name, kernel in ((768, "fused_window_attention", k2.fused_window_attention),
                                (1024, "wide_window_attention", k5.wide_window_attention)):
            flat, res = block(c, 32)
            x = t(B, 64, c, scale=0.5)
            a = kernel(x, *flat[2:6], flat[12], 32, 8, 1, 0, (8, 8), bf16)
            record(f"{name} C={c}", a)
            rp = dict(zip(("basis", "mean", "lam"), res))
            record(f"fused_residual_ffn C={c} res=True", k3.fused_residual_ffn(
                x.reshape(-1, c), a.reshape(-1, c), *flat[6:12], rp, double_ffn=True,
                mxu_dtype=bf16))
            record(f"fused_residual_ffn C={c} res=False", k3.fused_residual_ffn(
                x.reshape(-1, c), a.reshape(-1, c), *flat[6:12], None, mxu_dtype=bf16))
        a, w = t(8192, 96, scale=0.5).to(bf16), t(384, 96, scale=0.1).to(bf16)
        record("gemm", kg.gemm(a, w, bias=t(384), gelu=True, out_dtype=bf16))
    print(json.dumps({"root": root, "digests": digests}), flush=True)


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
    runs = []
    for root in argv:
        p = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                           text=True)
        sys.stdout.write(p.stdout)
        sys.stderr.write(p.stderr)
        if p.returncode:
            return p.returncode
        runs.append(json.loads(p.stdout.strip().splitlines()[-1])["digests"])
    same = {name: all(r[name] == runs[0][name] for r in runs) for name in runs[0]}
    print(json.dumps({"same_bits": same, "all_same": all(same.values())}), flush=True)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
