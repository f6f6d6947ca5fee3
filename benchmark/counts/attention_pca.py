"""Operations of one attention-PCA job over ``clips`` clips, as the
algorithm needs them (a multiply-add counts 2):

* the tapped forward of every clip (``htsat_forward``, no ResiDual);
* the moments: per layer and head, ``xᵀx`` of the flattened attention rows
  (one row a window), ``2 · rows · D²`` with ``D = (window²)²``;
* the randomized finalize per head (Halko et al. 2011), at the analysis
  path's fixed settings: ``k = 768`` components, 16 oversampling columns
  (``m = 784``), 6 power iterations: ``iters + 1`` products of the
  ``[D, D]`` covariance with the ``[D, m]`` block, as many Householder QRs
  with their Q formed (``4 D m² − 4/3 m³`` each), the Rayleigh-Ritz product
  (``2 D² m + 2 D m²``) and the ``[m, m]`` symmetric eigensolve (``9 m³``,
  with vectors).
"""

from __future__ import annotations

from benchmark.counts.htsat_forward import forward_ops, layer_shapes

__all__ = ["job_ops", "FINALIZE"]

FINALIZE = dict(k=768, oversample=16, iters=6)


def finalize_ops(d: int) -> float:
    m = min(FINALIZE["k"] + FINALIZE["oversample"], d)
    steps = FINALIZE["iters"] + 1
    return (steps * (2 * d * d * m + 4 * d * m * m - 4 / 3 * m ** 3)
            + 2 * d * d * m + 2 * d * m * m + 9 * m ** 3)


def job_ops(cfg: dict, clips: int) -> float:
    a = cfg["audio"]
    total = clips * forward_ops(cfg, classes=0)
    for s in layer_shapes(a):
        d = s["w2"] ** 2
        windows = s["n"] // s["w2"]
        total += s["heads"] * (2 * clips * windows * d * d + finalize_ops(d))
    return float(total)
