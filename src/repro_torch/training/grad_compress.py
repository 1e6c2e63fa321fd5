"""Int8 error-feedback gradient compression for the data-parallel
all-reduce (``repro.training.grad_compress``).

Gradients are quantised to int8 per block of ``BLOCK`` values before they
cross the data-parallel group, and the quantisation residual is fed back
into the next step's gradient. The order of operations is JAX's: an fp32
scale max|x| / 127 (1.0 where it is 0), codes round(x / scale) by division
(never by a reciprocal), rounded half to even, clamped to +-127.
``compressed_psum`` is the collective over ``torch.distributed`` in place of
JAX's ``shard_map`` + ``pmean``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

BLOCK = 256


def _pad_len(n: int) -> int:
    return (BLOCK - n % BLOCK) % BLOCK


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (any shape) -> (int8 codes (n_blocks, BLOCK), fp32 scales
    (n_blocks, 1))."""
    flat = g.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, _pad_len(flat.shape[0])))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress(codes: torch.Tensor, scale: torch.Tensor, shape,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor):
    """Error feedback: compress (g + residual); return the codes, the scale
    and the new residual (what the quantisation lost)."""
    corrected = g.to(torch.float32) + residual
    codes, scale = compress(corrected)
    approx = decompress(codes, scale, g.shape)
    return codes, scale, corrected - approx


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """Compress locally, all-reduce the dequantised values over ``group``
    (the default group when None) and return their mean over its ranks."""
    codes, scale = compress(g)
    approx = decompress(codes, scale, g.shape)
    dist.all_reduce(approx, group=group)
    return approx / dist.get_world_size(group)


def make_compressed_allreduce(group=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The gradient mean over ``group`` with int8 compression (the
    counterpart of the ``shard_map`` wrapper over a mesh's data axis)."""
    return lambda g: compressed_psum(g, group)
