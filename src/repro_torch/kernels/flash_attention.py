"""Prefill (flash) attention: the Hopper kernel ``csrc/flash_attention.cu``
and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` / ``_flash_kernel``). At serving shapes neither bytes
nor operations bound it on the H100 (both under a microsecond): the
latency of each block's tile loop does. In bf16 the kernel packs the G
query heads of a kv head into one block's 64 rows, so each K/V tile is
loaded once per group; it brings tiles in with double-buffered 16-byte
``cp.async`` copies and does both products on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulators, P rounded to bf16 in registers
before P.V), with an fp32 online softmax, masked-tile skipping and a ragged
S masked in the kernel. fp32 inputs take an fp32 FMA kernel, with no TF32.
See the source for the design.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = _build.ATTENTION_HEAD_DIMS


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,S,d); k/v: (B,Hkv,S,d). Full softmax attention in fp32."""
    B, Hq, S, d = q.shape
    group = Hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= (qp - kp) < window
    if chunk is not None:
        ok &= (qp // chunk) == (kp // chunk)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,S,d); k/v: (B,Hkv,S,d), any strides with a contiguous last
    dimension, base pointers and strides in multiples of 16 bytes;
    Hq % Hkv == 0. Returns (B,Hq,S,d); from the kernel it is a
    view of a contiguous (B,S,Hq,d) buffer, so ``.transpose(1, 2)`` gives the
    model's (B,S,Hq*d) layout without a copy. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if _build.use_plain("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk)
    code = _build.dtype_code("flash_attention", q, k, v)
    B, Hq, S, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[2] != S or k.shape[3] != d:
        raise ValueError(f"flash_attention: bad k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of Hkv={Hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: last dimension must be contiguous")
    _build.check_aligned("flash_attention", q, k, v)
    out = torch.empty((B, S, Hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.load_library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, S, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        int(causal), window or 0, chunk or 0, d ** -0.5, code,
        _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    return out
