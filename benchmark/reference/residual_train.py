"""Plain reference of ResiDual λ-training (arXiv:2411.00246, the zero-shot
objective): the mean cross-entropy of ``softmax(normalized @ textᵀ)``
against the labels, its gradient with respect to λ by autograd through the
plain forward of :mod:`benchmark.reference.htsat`, and Adam (Kingma & Ba;
β1 0.9, β2 0.999, ε 1e-8, bias-corrected). It imports nothing of the
program.
"""

from __future__ import annotations

import torch

from benchmark.reference import htsat as ref

__all__ = ["train_steps"]

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def train_steps(batches, sd: dict, cfg: dict, residual: dict, layer: int, text: torch.Tensor,
                lr: float, prec: ref.Precision) -> dict:
    """Adam steps on λ of ``residual[layer]``, one per ``(wav, labels)`` of
    ``batches``: ``{"losses", "grads", "lams"}`` with λ after each step."""
    lam = residual[layer]["lam"].detach().clone()
    m, v = torch.zeros_like(lam), torch.zeros_like(lam)
    out = {"losses": [], "grads": [], "lams": []}
    for t, (wav, labels) in enumerate(batches, start=1):
        leaf = lam.clone().requires_grad_(True)
        res = {layer: {**residual[layer], "lam": leaf}}
        with prec.context():
            e = ref.encode(wav, sd, cfg, residual=res, prec=prec, quantize=False)["normalized"]
            logp = torch.log_softmax(e @ text.t(), -1)
            loss = -logp.gather(-1, labels[:, None]).mean()
            (g,) = torch.autograd.grad(loss, [leaf])
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        lam = lam - lr * (m / (1 - BETA1 ** t)) / (torch.sqrt(v / (1 - BETA2 ** t)) + EPS)
        out["losses"].append(float(loss.detach()))
        out["grads"].append(g.detach())
        out["lams"].append(lam.detach())
    return out
