"""Autograd for the kernels: the kernel forward, the plain version's backward.

The JAX package has no backward Pallas kernel: its ``custom_vjp``s
differentiate the XLA twins (``ops/pallas/swin_block.py::_fsb_bwd``,
``ops/pallas/window_attention.py::_fwa_bwd``). :class:`Recompute` does the
same for K2-K5: its forward runs the kernel, its backward re-runs the
kernel's plain PyTorch version on the saved inputs under autograd, with the
same ``mxu_dtype``, and returns the grads ``ctx.needs_input_grad`` asks for
(x, K3's ``a``, the ResiDual ``lam`` in λ-training; frozen weights only when
asked). The cotangent reaches the plain version's f32 arithmetic in f32 (its
final cast to the store dtype passes it up), and each grad comes back in its
input's dtype, as ``_fsb_bwd`` casts ``dx``. The backward launches no kernel.

Each wrapper's ``*_autograd`` entry builds the :class:`Op` of its kernel and
applies :class:`Recompute`; the wrapper takes that entry for CUDA tensors only
when :func:`needs_graph` holds, so a forward without a tensor that requires
grad launches the kernels directly and builds no graph.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["Op", "Recompute", "needs_graph"]


class Op(NamedTuple):
    """A kernel and its plain version, both ``f(*tensors) -> tensor`` on the
    same positional tensors (None where an optional input is absent)."""

    kernel: Callable
    plain: Callable


def needs_graph(*tensors) -> bool:
    """Grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class Recompute(torch.autograd.Function):
    """Forward ``op.kernel(*tensors)``; backward through ``op.plain`` re-run
    on the saved inputs."""

    @staticmethod
    def forward(ctx, op: Op, *tensors):
        ctx.op = op
        ctx.save_for_backward(*tensors)
        return op.kernel(*tensors)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() if n else t
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.op.plain(*inputs)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, need) if n],
                                             grad_out.to(out.dtype)))
        return (None, *(next(grads) if n else None for n in need))
