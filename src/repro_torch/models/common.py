"""Parameter init and numerics shared by the model (``repro.models.common``).

The port adds DeepSeek-V2's YaRN rope frequencies (``rope_inv_freq``) and
its latent attention's softmax scale (``mla_softmax_scale``), which the
reference lacks.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, YarnScaling
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


# ---------------------------------------------------------------------------
# YaRN (DeepSeek-V2's modeling_deepseek.py: DeepseekV2YarnRotaryEmbedding)
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq_plain(dim: int, base: float, ys: YarnScaling) -> torch.Tensor:
    """The dim/2 inverse frequencies, fp32 on the CPU, as the published
    code computes them: theta's own (``freq_extra``) below the low
    correction dim, theta's over ``factor`` (``freq_inter``) above the high
    one, a linear ramp between (NTK-by-parts interpolation)."""
    i = torch.arange(0, dim, 2, dtype=torch.float32)
    extra = 1.0 / (base ** (i / dim))
    inter = 1.0 / (ys.factor * base ** (i / dim))
    low = max(math.floor(_correction_dim(ys.beta_fast, dim, base,
                                         ys.original_max_position_embeddings)), 0)
    high = min(math.ceil(_correction_dim(ys.beta_slow, dim, base,
                                         ys.original_max_position_embeddings)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


@functools.lru_cache(maxsize=None)
def _inv_freq_on(dim: int, base: float, ys: YarnScaling,
                 device: torch.device) -> torch.Tensor:
    return yarn_inv_freq_plain(dim, base, ys).to(device)


def rope_inv_freq(cfg: ModelConfig, dim: int,
                  device: torch.device) -> Optional[torch.Tensor]:
    """The rope kernel's table of inverse frequencies for ``cfg``'s yarn
    scaling, made once for each device (None without scaling: the kernel
    takes theta's). The published cos/sin scale, mscale over mscale_all_dim,
    is 1 for DeepSeek-V2 (both 0.707); any other is refused."""
    ys = cfg.rope_scaling
    if ys is None:
        return None
    if yarn_mscale(ys.factor, ys.mscale) != yarn_mscale(ys.factor, ys.mscale_all_dim):
        raise ValueError(f"{cfg.name}: yarn mscale {ys.mscale} != mscale_all_dim "
                         f"{ys.mscale_all_dim} scales cos and sin, which the "
                         "rope kernel does not")
    return _inv_freq_on(dim, float(cfg.rope_theta), ys, torch.device(device))


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """(qk_nope + qk_rope) ** -0.5, times yarn's mscale(mscale_all_dim)
    squared, as the published attention sets ``softmax_scale``."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    ys = cfg.rope_scaling
    if ys is not None and ys.mscale_all_dim:
        m = yarn_mscale(ys.factor, ys.mscale_all_dim)
        scale *= m * m
    return scale
