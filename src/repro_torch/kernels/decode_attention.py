"""Single-token decode attention: the Hopper kernel
``csrc/decode_attention.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``). Bytes bound it on the H100
(each K/V slot is read once and shared by the G query heads of its group),
so what limits it is how many loads are in flight and on how many SMs. The
kernel gives each (b, kv head, group tile) a thread-block cluster of
``n_split`` blocks and splits the row's valid span among them
(``split_geometry``): each block derives, on the device from ``pos``, the
row's visible positions [start, pos] (ring, window and chunk) and takes an
nth of them, so a short row of a long ring keeps every block busy, and a
full ring keeps the ranges of a split by capacity. Each block brings its
piece in with 16-byte ``cp.async`` copies and computes a partial (m, l,
acc) for each query head of its tile, one warp a head; the cluster's first
block merges the partials from distributed shared memory, all in one
launch, whose grid depends on shapes only. A group of any size runs: it is
cut into tiles of at most ``max_heads`` heads (``group_tiles``), and a
group of T tiles reads the ring T times. See the source for the design.

``decode_attention_int8`` is the same kernel over the int8 ring of
``cfg.kv_quant``: it reads the codes (half the bytes of bf16) and their
per-token-per-head scales and dequantizes in the kernel. It has no Pallas
counterpart; it replaces the XLA chain ``dequantize_kv`` + masked softmax
attention of ``repro/models/attention.py::decode_attend``.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = _build.ATTENTION_HEAD_DIMS
MAX_SPLIT = 8      # the kernel's cluster size: the largest portable one


def split_geometry(C: int, pos: int, window: Optional[int] = None,
                   chunk: Optional[int] = None) -> List[Tuple[int, int]]:
    """Each block's piece of a row at position ``pos`` of a ring of C
    slots, as the kernel cuts it (``split_span`` in the source): a list of
    ``n_split = min(8, C)`` pairs (first slot, slots), block i reading the
    slots (first + o) mod C for o < slots. The row's visible positions are
    [start, pos], start = max(0, pos - C + 1, pos - window + 1,
    floor(pos / chunk) * chunk), n = pos - start + 1 of them (none for pos <
    0) in the slots (start + o) mod C; block i takes the offsets [i * per,
    min(n, i * per + per)), per = ceil(n / n_split), counted from slot start
    mod C, or from slot 0 when the span is the whole ring (n = C), which
    gives a full ring the ranges of a split by capacity. The kernel decides
    on the device; this mirrors it for labels and tests only, and must be
    changed with it."""
    if C < 1:
        raise ValueError(f"decode_attention: ring of {C} slots")
    n_split = min(MAX_SPLIT, C)
    start = max(0, pos - C + 1)
    if window:
        start = max(start, pos - window + 1)
    if chunk:
        start = max(start, pos // chunk * chunk)
    n = max(0, pos - start + 1)
    per = -(-n // n_split)
    a = 0 if n == C else start % C
    out = []
    for i in range(n_split):
        lo = min(n, i * per)
        out.append(((a + lo) % C, min(n, lo + per) - lo))
    return out


def occupancy(Hkv: int, C: int, G: int, d: int, dtype: torch.dtype,
              int8: bool = False) -> dict:
    """The card's residency for a launch of the kernel (or of its int8
    variant) at Hkv kv heads of G query heads each, head dim d and a ring
    of C slots: threads and dynamic shared memory a block, blocks resident
    on one SM and clusters resident on the card at once, and the blocks of
    a cluster. Asks the CUDA runtime; on the card only."""
    res = (ctypes.c_int * 5)()
    lib = _build.load_library()
    _build.check(lib.repro_decode_attention_occupancy(
        Hkv, C, G, d, _build.DTYPE_CODES[dtype], int(int8), res),
        "decode_attention occupancy")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm",
                     "clusters_resident", "n_split"), res))


def max_heads(dtype: torch.dtype, d: int, int8: bool = False) -> int:
    """The most query heads one block (a group tile, one warp a head) of
    the kernel holds: 32, but 16 for the fp32 kernel at head dims 96 and
    128 (its thread bound, under which those instances do not spill)."""
    return 16 if dtype == torch.float32 and d > 64 and not int8 else 32


def group_tiles(G: int, max_heads: int) -> Tuple[int, int]:
    """The kernel's cut of a group of G query heads into tiles of at most
    ``max_heads``, as even as they come: (tiles, heads per tile); the last
    tile may hold fewer, none is empty. The C entry points decide it
    (``group_tiles`` in the source); this mirrors it for labels and tests
    only, and must be changed with it."""
    if G < 1:
        raise ValueError(f"decode_attention: a group of {G} heads")
    n = -(-G // max_heads)
    return n, -(-G // n)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, *, window: Optional[int] = None,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,d); k/v: (B,Hkv,C,d) ring buffers; pos: (B,) -> (B,Hq,d)."""
    B, Hq, d = q.shape
    _, Hkv, C, _ = k.shape
    group = Hq // Hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhcd->bhc", q.float(), k.float()) * (d ** -0.5)
    j = torch.arange(C, device=q.device)[None, :]
    p = pos[:, None].long()
    pslot = p - torch.remainder(p - j, C)
    ok = pslot >= 0
    if window is not None:
        ok &= (p - pslot) < window
    if chunk is not None:
        ok &= (torch.div(pslot, chunk, rounding_mode="floor")
               == torch.div(p, chunk, rounding_mode="floor"))
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhc,bhcd->bhd", w, v.float()).to(q.dtype)


def _check_ring(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                pos: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """What both kernels need of q, the ring k/v and pos: shapes, the
    group, the head dim, contiguous last dimensions, (B,) int32 pos and
    16-byte aligned rows. Returns (B, Hq, d, Hkv, C)."""
    B, Hq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"{name}: bad k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} for q {tuple(q.shape)}")
    _, Hkv, C, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{name}: Hq={Hq} over Hkv={Hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    if pos.shape != (B,) or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be contiguous (B,) int32")
    _build.check_aligned(name, q, k, v)
    return B, Hq, d, Hkv, C


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,d); k/v: (B,Hkv,C,d) ring buffers, any strides with a
    contiguous last dimension, base pointers and strides in multiples of 16
    bytes; pos: (B,) int32. Token t lives in slot
    t % C and the current token's K/V must already be at slot pos % C.
    Any group G = Hq / Hkv. CPU tensors take the plain version, CUDA tensors
    the kernel; on the card a head dim outside ``HEAD_DIMS`` raises."""
    if _build.use_plain("decode_attention", q, k, v, pos):
        return decode_attention_plain(q, k, v, pos, window=window, chunk=chunk)
    code = _build.dtype_code("decode_attention", q, k, v)
    B, Hq, d, Hkv, C = _check_ring("decode_attention", q, k, v, pos)
    out = torch.empty((B, Hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    err = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, Hkv, C, Hq // Hkv, d,
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        window or 0, chunk or 0, d ** -0.5, code, _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    return out


def decode_attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                k_scale: torch.Tensor, v_scale: torch.Tensor,
                                pos: torch.Tensor, *, window: Optional[int] = None,
                                chunk: Optional[int] = None) -> torch.Tensor:
    """``decode_attention_plain`` on the dequantized ring: k/v (B,Hkv,C,d)
    int8 codes, k/v_scale (B,Hkv,C) in q's dtype; each element is
    float(code) * float(scale) cast to q's dtype, as ``dequantize_kv``."""
    kd = (k.float() * k_scale[..., None].float()).to(q.dtype)
    vd = (v.float() * v_scale[..., None].float()).to(q.dtype)
    return decode_attention_plain(q, kd, vd, pos, window=window, chunk=chunk)


def decode_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor,
                          pos: torch.Tensor, *, window: Optional[int] = None,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,Hq,d) bf16 or fp32; k/v: (B,Hkv,C,d) int8 codes with a
    contiguous last dimension, base pointers and strides in multiples of 16
    bytes; k/v_scale: (B,Hkv,C) in q's dtype, any strides; pos: (B,) int32.
    The ring rule is ``decode_attention``'s. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if _build.use_plain("decode_attention_int8", q, k, v, k_scale, v_scale, pos):
        return decode_attention_int8_plain(q, k, v, k_scale, v_scale, pos,
                                           window=window, chunk=chunk)
    code = _build.dtype_code("decode_attention_int8", q, k_scale, v_scale)
    if k.dtype != torch.int8 or v.dtype != torch.int8:
        raise TypeError(f"decode_attention_int8: codes must be int8, got "
                        f"{k.dtype}, {v.dtype}")
    B, Hq, d, Hkv, C = _check_ring("decode_attention_int8", q, k, v, pos)
    if k_scale.shape != (B, Hkv, C) or v_scale.shape != (B, Hkv, C):
        raise ValueError(f"decode_attention_int8: scales {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)}, expected {(B, Hkv, C)}")
    out = torch.empty((B, Hq, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    err = lib.repro_decode_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, Hkv, C, Hq // Hkv, d,
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        *k_scale.stride(), *v_scale.stride(),
        window or 0, chunk or 0, d ** -0.5, code, _build.stream_ptr(q))
    _build.check(err, "decode_attention_int8")
    return out
