"""The frozen operation and byte counts against counts made by hand for
both configurations (a multiply-add counts 2)."""

from __future__ import annotations

import json

import pytest

from benchmark.core import ROOT
from benchmark.counts import attention_pca, htsat_forward, lambda_step


def _cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def _block(n, c, w2, ffn_passes=1, k=0):
    # qkv + scores + attend + proj + FFN passes + the ResiDual's two products
    return (2 * n * c * 3 * c + 2 * 2 * n * w2 * c + 2 * n * c * c
            + ffn_passes * 2 * 2 * n * c * 4 * c + 2 * 2 * n * c * k)


# frontend: 1001 frames; the DFT at 513 bins (cos and sin), the mel product,
# the bicubic stretch 1001 -> 1024 frames over 64 mels
FRONTEND = 1001 * 2 * 2 * 1024 * 513 + 1001 * 2 * 513 * 64 + 2 * 1024 * 1001 * 64


def _hand(e, depths, tower, residual):
    out = {"frontend": FRONTEND}
    for i, depth in enumerate(depths):
        res, c = 64 >> i, e << i
        n, w2 = res * res, min(8, res) ** 2
        k = c if (residual and i == 0) else 0
        ops = depth * _block(n, c, w2, 2 if k else 1, k)
        if i == 0:
            ops += 2 * 64 * 64 * e * 16  # the patch embedding, 4x4 patches
        if i < 3:
            ops += 2 * (n // 4) * 4 * c * 2 * c  # patch merging
        out[f"layer{i}"] = ops
    out["head"] = 2 * 64 * tower * 527 * 3 + 2 * (tower * 512 + 512 * 512) + 2 * 512 * 50
    return out


@pytest.mark.parametrize("name,e,depths,tower", [("htsat-tiny", 96, (2, 2, 6, 2), 768),
                                                  ("htsat-base", 128, (2, 2, 12, 2), 1024)])
def test_forward_stages(name, e, depths, tower):
    cfg = _cfg(name)
    assert htsat_forward.stage_ops(cfg, residual={0: e}) == _hand(e, depths, tower, True)
    plain = htsat_forward.stage_ops(cfg)
    assert plain == _hand(e, depths, tower, False)
    assert htsat_forward.forward_ops(cfg) == sum(plain.values())


def test_forward_totals():
    # the totals the benchmark's MFU divides, for the record
    assert round(htsat_forward.forward_ops(_cfg("htsat-tiny"), residual={0: 96}) / 1e9, 3) \
        == 15.782
    assert round(htsat_forward.forward_ops(_cfg("htsat-base"), residual={0: 128}) / 1e9, 3) \
        == 35.845


@pytest.mark.parametrize("name,e", [("htsat-tiny", 96), ("htsat-base", 128)])
def test_swin_bytes(name, e):
    cfg = _cfg(name)
    b = 128
    depths = cfg["audio"]["depths"]
    total = b * 256 * 256 * 2 + 16 * e * 2 + 3 * e * 4  # image in, patch kernel, bias + norm
    for i, depth in enumerate(depths):
        c, n, nh = e << i, (64 >> i) ** 2, cfg["audio"]["num_heads"][i]
        total += depth * ((3 * c * c + c * c + 8 * c * c) * 2
                          + (3 * c + c + 4 * c + c + 4 * c + 225 * nh) * 4)
        if i < 3:
            total += 8 * c * c * 2 + 8 * c * 4 + 2 * b * (n // 4) * (2 * c) * 2
        else:
            total += b * n * c * 2
    assert htsat_forward.swin_bytes(cfg, b, act_bytes=2, weight_bytes=2) == total


@pytest.mark.parametrize("name,e", [("htsat-tiny", 96), ("htsat-base", 128)])
def test_lambda_step(name, e):
    cfg = _cfg(name)
    fwd = htsat_forward.stage_ops(cfg, residual={0: e})
    forward = sum(fwd.values()) - fwd["frontend"]
    back = 0
    for i, depth in enumerate(cfg["audio"]["depths"]):
        res, c = 64 >> i, e << i
        n, w2 = res * res, min(8, res) ** 2
        k = e if i == 0 else 0
        ffn = (2 if k else 1) * 2 * 2 * n * c * 4 * c
        attn = 2 * n * c * 3 * c + 2 * n * c * c + 2 * (2 * 2 * n * w2 * c)
        for j in range(depth):
            if i == 0 and j == 0:  # λ's first block: the dλ product and the FFNs after it
                back += ffn + 2 * n * c * k
            else:
                back += ffn + attn + 2 * 2 * n * c * k
        if i < 3:
            back += 2 * (n // 4) * 4 * c * 2 * c
    back += 2 * ((8 * e) * 512 + 512 * 512) + 2 * 512 * 50
    assert lambda_step.step_ops(cfg, layer=0, k=e) == forward + back


def test_attention_pca_job():
    cfg = _cfg("htsat-tiny")
    d, m = 4096, 784
    finalize = 7 * (2 * d * d * m + 4 * d * m * m - 4 / 3 * m ** 3) + 2 * d * d * m \
        + 2 * d * m * m + 9 * m ** 3
    moments = sum(h * 2 * 400 * w * d * d for h, w in ((4, 64), (8, 16), (16, 4), (32, 1)))
    want = 400 * htsat_forward.forward_ops(cfg, classes=0) + moments + 60 * finalize
    assert attention_pca.job_ops(cfg, 400) == pytest.approx(want, rel=1e-12)
