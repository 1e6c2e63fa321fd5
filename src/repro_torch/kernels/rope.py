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

A model with scaled frequencies (DeepSeek-V2's YaRN,
``models/common.py:rope_inv_freq``) passes its table of inverse
frequencies as ``inv_freq`` (fp32, hd/2 entries, on the tensors' device);
without it the frequencies are theta's. ``rope_append``'s v may have a
head width of its own: latent attention writes its 512-wide latent as v
and the roped 64-wide shared key as k into two views of one ring row.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 512     # csrc/rope.cu: kMaxHalf cos/sin entries a row


def rope_plain(x: torch.Tensor, positions: torch.Tensor, theta: float,
               inv_freq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotary embedding, rotate-half layout. x: (..., S, H, D); positions:
    (..., S) or (S,); ``inv_freq`` (D/2,) fp32 in place of theta's
    frequencies. Differentiable torch ops on any device."""
    d = x.shape[-1]
    half = d // 2
    if inv_freq is not None:
        freqs = inv_freq.to(device=x.device, dtype=torch.float32)
    else:
        freqs = torch.exp(-math.log(theta)
                          * torch.arange(0, half, dtype=torch.float32,
                                         device=x.device)
                          / half)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def rope_append_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                      pos: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, theta: float,
                      inv_freq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rope q (B,1,Hq,hd) and k_new (B,1,KV,hd) at pos (B,), write the
    roped k_new into slot pos % C of the (B,C,KV*hd) ring k_cache and
    v_new (B,1,KV,vd) into that of the (B,C,KV*vd) ring v_cache, in place;
    returns the roped q."""
    B, C = k_cache.shape[:2]
    q = rope_plain(q, pos[:, None], theta, inv_freq)
    k_new = rope_plain(k_new, pos[:, None], theta, inv_freq)
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


def _check_table(name: str, inv_freq: Optional[torch.Tensor], hd: int,
                 like: torch.Tensor) -> int:
    """The table's pointer (0 for none): (hd/2,) contiguous fp32 on like's
    device."""
    if inv_freq is None:
        return 0
    if inv_freq.shape != (hd // 2,) or inv_freq.dtype != torch.float32 \
            or not inv_freq.is_contiguous() or inv_freq.device != like.device:
        raise ValueError(f"{name}: inv_freq must be a contiguous ({hd // 2},) "
                         f"fp32 table on {like.device}")
    return inv_freq.data_ptr()


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float, inv_freq: Optional[torch.Tensor] = None):
    """q (B,S,Hq,hd) and k (B,S,KV,hd) roped at positions (S,) or (B,S)
    int32: returns (q, k), fresh and contiguous. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if _build.use_plain("rope", q, k, positions):
        return (rope_plain(q, positions, theta, inv_freq),
                rope_plain(k, positions, theta, inv_freq))
    name = "rope"
    code, B, S, Hq, KV, hd = _check(name, q, k)
    _check_pos(name, positions)
    table = _check_table(name, inv_freq, hd, q)
    pos = positions.expand(B, S)
    q_out = torch.empty((B, S, Hq, hd), dtype=q.dtype, device=q.device)
    k_out = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    err = _build.load_library().repro_rope(
        q.data_ptr(), k.data_ptr(), None, pos.data_ptr(), q_out.data_ptr(),
        k_out.data_ptr(), None, B, S, Hq, KV, hd, 0,
        *q.stride()[:3], *k.stride()[:3], 0, 0, 0, *pos.stride(),
        S * KV * hd, KV * hd, 0, 0, -math.log(theta), table, hd, code,
        _build.stream_ptr(q))
    _build.check(err, name)
    return q_out, k_out


def rope_append(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                theta: float, inv_freq: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """A decode step's rope and ring write: q (B,1,Hq,hd) and k_new
    (B,1,KV,hd) roped at pos (B,) int32, the roped k_new written into slot
    pos % C of the ring k_cache (B,C,KV*hd) and v_new (B,1,KV,vd) into that
    of v_cache (B,C,KV*vd), in place (base pointers and strides in
    multiples of 16 bytes, as the decode kernels read them). Returns the
    roped q, fresh and contiguous. CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if _build.use_plain("rope_append", q, k_new, v_new, pos, k_cache, v_cache):
        return rope_append_plain(q, k_new, v_new, pos, k_cache, v_cache, theta,
                                 inv_freq)
    name = "rope_append"
    code, B, S, Hq, KV, hd = _check(name, q, k_new, v_new, k_cache, v_cache)
    C, vd = k_cache.shape[1], v_new.shape[-1]
    if S != 1 or v_new.shape[:3] != k_new.shape[:3] or C < 1 \
            or k_cache.shape != (B, C, KV * hd) or v_cache.shape != (B, C, KV * vd):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k/v_new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, rings "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    _check_pos(name, pos)
    if pos.shape != (B,) or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be contiguous (B,) int32")
    # a ring the decode kernel would refuse is refused before it is written
    _build.check_aligned(name, k_cache, v_cache)
    table = _check_table(name, inv_freq, hd, q)
    q_out = torch.empty((B, 1, Hq, hd), dtype=q.dtype, device=q.device)
    err = _build.load_library().repro_rope(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(),
        q_out.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        B, 1, Hq, KV, hd, C, *q.stride()[:3], *k_new.stride()[:3],
        *v_new.stride()[:3], 1, 0, *k_cache.stride()[:2], *v_cache.stride()[:2],
        -math.log(theta), table, vd, code, _build.stream_ptr(q))
    _build.check(err, name)
    return q_out
