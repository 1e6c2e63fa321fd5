"""Rotary embedding of q and k, and a decode step's ring write: the Hopper
kernel ``csrc/rope.cu`` and its plain version.

Replaces no TPU kernel: the JAX package ropes with jnp ops that XLA fuses
(``repro/models/common.py::rope``) and writes the new K/V into the ring with
an indexed update (``repro/models/attention.py::decode_attend``). Run
eagerly these took 41 launches of a decode layer (18 per rope call, 5 for
the ring write), and the host's dispatch of them bounded the served decode
step. The kernel does them in one launch: ``rope`` at a prefill (q and k),
``rope_append`` at a decode step (q and k at ``pos``, then the roped k and
v into slot ``pos % C`` of the rings, in place). Bytes bound it (one read
and one write of q, k and v); each block ropes one row, computing its cos
and sin once for every head. See the source for the design and the
numerics, which follow the plain version's fp32 op order on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 512     # csrc/rope.cu: kMaxHalf cos/sin entries a row


def rope_plain(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half layout. x: (..., S, H, D); positions:
    (..., S) or (S,). Differentiable torch ops on any device."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def rope_append_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      pos: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, theta: float) -> torch.Tensor:
    """Rope q (B,1,Hq,hd) and k_new (B,1,KV,hd) at pos (B,), write the
    roped k_new and v_new (B,1,KV,hd) into slot pos % C of the (B,C,KV*hd)
    rings in place; returns the roped q."""
    B, C = k_cache.shape[:2]
    q = rope_plain(q, pos[:, None], theta)
    k_new = rope_plain(k_new, pos[:, None], theta)
    slot = torch.remainder(pos.long(), C)
    bidx = torch.arange(B, device=q.device)
    k_cache[bidx, slot] = k_new[:, 0].reshape(B, -1)
    v_cache[bidx, slot] = v_new[:, 0].reshape(B, -1)
    return q


def _check(name: str, q: torch.Tensor, k: torch.Tensor, *more: torch.Tensor):
    """What both entry points need: one dtype, (B,S,H,hd) q and k of one
    batch, length and even head dim, contiguous last dimensions. Returns
    (dtype code, B, S, Hq, KV, hd)."""
    code = _build.dtype_code(name, q, k, *more)
    if q.dim() != 4 or k.dim() != 4 or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "must be (B,S,Hq,hd) and (B,S,KV,hd)")
    B, S, Hq, hd = q.shape
    if hd % 2 or not 2 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} must be even, 2 to {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, *more)):
        raise ValueError(f"{name}: last dimension must be contiguous")
    return code, B, S, Hq, k.shape[2], hd


def _check_pos(name: str, pos: torch.Tensor) -> None:
    if pos.dtype != torch.int32:
        raise TypeError(f"{name}: positions must be int32, got {pos.dtype}")


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float):
    """q (B,S,Hq,hd) and k (B,S,KV,hd) roped at positions (S,) or (B,S)
    int32: returns (q, k), fresh and contiguous. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if _build.use_plain("rope", q, k, positions):
        return rope_plain(q, positions, theta), rope_plain(k, positions, theta)
    name = "rope"
    code, B, S, Hq, KV, hd = _check(name, q, k)
    _check_pos(name, positions)
    pos = positions.expand(B, S)
    q_out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    k_out = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    err = _build.load_library().repro_rope(
        q.data_ptr(), k.data_ptr(), None, pos.data_ptr(), q_out.data_ptr(),
        k_out.data_ptr(), None, B, S, Hq, KV, hd, 0,
        *q.stride()[:3], *k.stride()[:3], 0, 0, 0, *pos.stride(),
        S * KV * hd, KV * hd, 0, 0, -math.log(theta), code, _build.stream_ptr(q))
    _build.check(err, name)
    return q_out, k_out


def rope_append(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                theta: float) -> torch.Tensor:
    """A decode step's rope and ring write: q (B,1,Hq,hd) and k_new
    (B,1,KV,hd) roped at pos (B,) int32, the roped k_new and v_new
    (B,1,KV,hd) written into slot pos % C of the rings k/v_cache
    (B,C,KV*hd) in place (base pointers and strides in multiples of 16
    bytes, as the decode kernel reads them). Returns the roped q, fresh and
    contiguous. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if _build.use_plain("rope_append", q, k_new, v_new, pos, k_cache, v_cache):
        return rope_append_plain(q, k_new, v_new, pos, k_cache, v_cache, theta)
    name = "rope_append"
    code, B, S, Hq, KV, hd = _check(name, q, k_new, v_new, k_cache, v_cache)
    C = k_cache.shape[1]
    if S != 1 or v_new.shape != k_new.shape or C < 1 \
            or k_cache.shape != (B, C, KV * hd) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k/v_new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, rings "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    _check_pos(name, pos)
    if pos.shape != (B,) or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be contiguous (B,) int32")
    # a ring the decode kernel would refuse is refused before it is written
    _build.check_aligned(name, k_cache, v_cache)
    q_out = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=q.device)
    err = _build.load_library().repro_rope(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(),
        q_out.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        B, 1, Hq, KV, hd, C, *q.stride()[:3], *k_new.stride()[:3],
        *v_new.stride()[:3], 1, 0, *k_cache.stride()[:2], *v_cache.stride()[:2],
        -math.log(theta), code, _build.stream_ptr(q))
    _build.check(err, name)
    return q_out
