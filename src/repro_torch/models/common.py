"""Parameter init and numerics shared by the model (``repro.models.common``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.rmsnorm import rmsnorm_plain


def init_param(shape, generator: torch.Generator, dtype: torch.dtype,
               device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """Truncated normal in [-2, 2] times ``scale / sqrt(fan_in)``, drawn in
    fp32 from ``generator`` (on its own device), then cast and moved.

    fan_in is ``shape[-2]`` (the JAX (d_in, d_out) orientation) or
    ``shape[-1]`` for a vector. The numbers differ from ``jax.random``'s;
    tests that compare with JAX bring the JAX weights across instead.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype=dtype, device=device)


class GradCast(torch.autograd.Function):
    """Identity forward; the backward casts the cotangent to ``dtype``
    (``repro.models.common.grad_cast``): the fp32 loss head would otherwise
    carry an fp32 cotangent down the residual stream."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.to(ctx.dtype), None


def grad_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return GradCast.apply(x, dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             is_train: bool = False) -> torch.Tensor:
    """fp32 normalise, cast to x's dtype, times the gain. Serving goes
    through ``ops.rmsnorm`` (the kernel on the card); ``is_train`` takes the
    differentiable torch ops of ``rmsnorm_plain`` on any device, as JAX
    trains on XLA's ``rms_norm`` and never on its Pallas kernel."""
    if is_train:
        return rmsnorm_plain(x, scale, eps)
    return ops.rmsnorm(x, scale, eps=eps)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in the input dtype."""
    return F.silu(x_gate) * x_up
