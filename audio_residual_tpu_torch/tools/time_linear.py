"""Time the 3xTF32 linear (``ops/cuda/linear.py``) at RoBERTa-base's training
shapes on one card:

    python3 -m audio_residual_tpu_torch.tools.time_linear [--sweep] [--out FILE]

Rows M = 96 texts x 77 tokens = 7392; (N, K) = (768, 768) (q, k, v, out),
(3072, 768) (fc1), (768, 3072) (fc2). Prints one JSON line a measurement:

* ``product``: each product alone as the plan runs it, event ms and TFLOP/s
  against the 165 TFLOP/s of three TF32 passes; with ``--sweep`` also the
  forward's other N tiles and the weight gradient's other (N tile, splits)
  pairs, the times that ``tf32x3.KTILE_FIXED_COLUMNS`` and the weight
  gradient's constants (``linear.py``) are fitted to;
* ``linear``: forward + backward of one linear, event ms, against
  ``F.linear`` and its autograd (cuBLAS f32), the TFLOP/s of its three
  products, and the host's µs a call (the same call at M = 128, whose
  device work the host does not wait for: 200 calls timed on the host
  clock, then one synchronize);
* ``roberta``: RoBERTa-base's training forward and backward at B = 96,
  L = 77 with dropout, golden, on the 3xTF32 linear and on ``F.linear``.

Its correctness is the card tests' (``tests/test_torch_cuda.py``) and
``chip_smoke.py``'s phase 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from unittest import mock

import torch

from audio_residual_tpu_torch.ops.cuda import linear as L
from audio_residual_tpu_torch.ops.cuda import tf32x3
from audio_residual_tpu_torch.ops.cuda.build import sm_count
from audio_residual_tpu_torch.utils.profiling import time_ms

M = 96 * 77
SHAPES = ((768, 768), (3072, 768), (768, 3072))
X3_PEAK = 165e12  # three passes of the H100's 495 TFLOP/s TF32 rate
HOST_M, HOST_CALLS = 128, 200
OUT = []


def emit(**kv) -> None:
    line = json.dumps(kv)
    OUT.append(line)
    print(line, flush=True)


def randn(*shape, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, device="cuda", generator=g) * scale


def time_products(sweep: bool) -> None:
    sms = sm_count(torch.device("cuda"))
    for n, k in SHAPES:
        a = randn(M, k, seed=5)
        w = randn(n, k, seed=6, scale=k ** -0.5)
        hi, lo = tf32x3.split_tf32(w)
        planned = tf32x3.gemm_plan(M, n, k, sms).bn
        for bn in tf32x3.GEMM_BNS if sweep else (planned,):
            plan = tf32x3.gemm_plan(M, n, k, sms)
            plan = dataclasses.replace(plan, bn=bn, stages=tf32x3.ring(bn)[0])
            with mock.patch.object(tf32x3, "gemm_plan", lambda *_, plan=plan: plan):
                ms = time_ms(lambda: L._product(a, hi, lo, None, False), reps=20, warmup=3)
            emit(kind="product", what="forward", m=M, n=n, k=k, bn=bn, planned=bn == planned,
                 ms=ms, tflops=2 * M * n * k / ms / 1e9,
                 share_of_x3_peak=100 * 2 * M * n * k / ms / 1e9 / (X3_PEAK / 1e12))
        dy, x = randn(M, n, seed=8), randn(M, k, seed=9)
        wplan = L.weight_grad_plan(M, n, k, sms)
        src_b, src_a = (x, dy) if wplan.b_is_x else (dy, x)
        ms_split = time_ms(lambda: L.split_t(src_b, wplan.red), reps=20, warmup=3)
        bhi, blo = L.split_t(src_b, wplan.red)
        emit(kind="product", what="split_t", rows=M, cols=src_b.shape[1], ms=ms_split,
             tb_s=3 * src_b.numel() * 4 / ms_split / 1e9)
        cands = [(wplan.bn, wplan.splits)]
        if sweep:
            cands += [(bn, s) for bn in (128, 96, 64) for s in (1, 2, 4, 6, 8, 11, 16, 22)]
        k_tiles = -(-wplan.red // tf32x3.K_STEP)
        for bn, s in cands:
            if (s - 1) * -(-k_tiles // s) >= k_tiles:
                continue  # a split without a k-tile
            plan = dataclasses.replace(wplan, bn=bn, stages=tf32x3.ring(bn)[0], splits=s)
            ms = time_ms(lambda: L._parts(src_a, bhi, blo, plan), reps=20, warmup=3)
            parts = L._parts(src_a, bhi, blo, plan)
            ms_sum = time_ms(lambda: parts.sum(0), reps=20, warmup=3) if s > 1 else 0.0
            emit(kind="product", what="weight_grad", m=M, n=n, k=k, bn=bn, splits=s,
                 planned=(bn, s) == (wplan.bn, wplan.splits), ms=ms, sum_ms=ms_sum,
                 tflops=2 * M * n * k / (ms + ms_sum) / 1e9)


def host_us(fn, x, w, b, g) -> float:
    """Host µs of one forward + backward at M = HOST_M: the calls enqueue
    faster than the card runs them, so the host clock times the host."""
    def step():
        torch.autograd.grad(fn(x, w, b), [x, w, b], g)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        step()
    us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
    torch.cuda.synchronize()
    return us


def time_linear() -> None:
    for n, k in SHAPES:
        x = randn(M, k, seed=1).requires_grad_()
        w = randn(n, k, seed=2, scale=k ** -0.5).requires_grad_()
        b = randn(n, seed=3, scale=0.1).requires_grad_()
        g = randn(M, n, seed=4)
        small = (x[:HOST_M].detach().requires_grad_(), w, b, g[:HOST_M])
        flops = 3 * 2 * M * n * k
        row = {}
        for name, fn in (("x3", L.linear_tf32x3), ("cublas_f32", L.linear_plain)):
            ms = time_ms(lambda: torch.autograd.grad(fn(x, w, b), [x, w, b], g), reps=20,
                         warmup=3)
            row[name] = {"ms": ms, "tflops": flops / ms / 1e9, "host_us": host_us(fn, *small)}
        emit(kind="linear", n=n, k=k, m=M, **row)


def time_roberta() -> None:
    from audio_residual_tpu_torch.models import roberta as R

    cfg = R.RobertaConfig()
    model = R.Roberta(cfg).cuda()
    gen = torch.Generator(device="cuda")
    ids = torch.randint(3, cfg.vocab_size, (96, 77), device="cuda", generator=gen.manual_seed(11))
    ids[:, 30:] = cfg.pad_token_id
    masks = R.sample_dropout(gen.manual_seed(12), cfg, 96, 77)

    def fwd():
        return R.roberta_apply(model, ids, dropout=masks)["pooler_output"]

    for route, takes in (("x3", R.takes), ("f32", lambda x, w: False)):
        with mock.patch.object(R, "takes", takes):
            emit(kind="roberta", route=route,
                 train_step_ms=time_ms(lambda: fwd().square().sum().backward(), reps=10,
                                       warmup=2),
                 forward_ms=time_ms(fwd, reps=10, warmup=2))
        model.zero_grad(set_to_none=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    emit(kind="device", name=torch.cuda.get_device_name(), sms=sm_count(torch.device("cuda")))
    time_products(args.sweep)
    time_linear()
    time_roberta()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(OUT) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
