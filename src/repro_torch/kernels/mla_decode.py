"""Absorbed latent-attention (MLA) decode over a latent ring: the Hopper
kernel ``csrc/mla_decode.cu`` and its plain version.

Replaces no TPU kernel: the JAX package has no latent attention. A
DeepSeek-V2 decode step keeps one latent row a token, [c (512) | k_rope
(64)], and multiplies each head's q_nope into the latent space (W_UK)
beforehand, so a head's query is [q_lat | q_rope] (576), its scores are q .
ring over all 576 and its output is the softmax's weights . ring[:, :512]:
all heads share one "KV head" of key 576 and value 512. Bytes bound it on
the H100 (each valid latent row, 1,152 B, read once for all 16 heads), and
at 30 FLOPs a byte its products go to the tensor cores. The kernel gives
each row a thread-block cluster of up to 8 blocks that split the row's
valid span, and merges their partials in distributed shared memory, in one
launch. See the source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
LATENT = 512          # value width: the latent
SCORE = 576           # key width: latent and rope
MAX_HEADS = 16        # query heads a launch takes: the rows of an mma tile


def mla_decode_plain(q: torch.Tensor, ring: torch.Tensor, pos: torch.Tensor,
                     scale: float, latent: int = LATENT) -> torch.Tensor:
    """q: (B,H,dk); ring: (B,C,dk), the first ``latent`` columns of a row
    its value; pos: (B,). Softmax attention over each row's written slots
    (slot j holds position pos - ((pos - j) mod C), visible if that is not
    negative), in fp32; returns (B,H,latent) in q's dtype."""
    C = ring.shape[1]
    rf = ring.float()
    s = torch.einsum("bhd,bcd->bhc", q.float(), rf) * scale
    j = torch.arange(C, device=q.device)[None, :]
    p = pos[:, None].long()
    ok = (p - torch.remainder(p - j, C)) >= 0
    s = torch.where(ok[:, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhc,bcd->bhd", w, rf[..., :latent]).to(q.dtype)


def mla_decode(q: torch.Tensor, ring: torch.Tensor, pos: torch.Tensor,
               scale: float, latent: int = LATENT) -> torch.Tensor:
    """q: (B,H,576) bf16, H <= 16; ring: one layer's latent ring (B,C,576)
    bf16, any strides with a contiguous last dimension, base pointers and
    strides in multiples of 16 bytes, the first ``latent`` (512) columns of
    a row its value; pos: (B,) int32, the current token's position, its
    latent already in slot pos % C. Returns (B,H,latent). CPU tensors take
    the plain version (any widths), CUDA tensors the kernel."""
    if _build.use_plain("mla_decode", q, ring, pos):
        return mla_decode_plain(q, ring, pos, scale, latent)
    name = "mla_decode"
    if q.dtype != torch.bfloat16 or ring.dtype != torch.bfloat16:
        raise TypeError(f"{name}: bf16 only, got {q.dtype}, {ring.dtype}")
    if q.dim() != 3 or ring.dim() != 3 or q.shape[-1] != SCORE \
            or ring.shape[-1] != SCORE or ring.shape[0] != q.shape[0] \
            or latent != LATENT:
        raise ValueError(f"{name}: q {tuple(q.shape)} and ring "
                         f"{tuple(ring.shape)} must be (B,H,{SCORE}), "
                         f"(B,C,{SCORE}) with a value of {LATENT}, got {latent}")
    B, H, _ = q.shape
    C = ring.shape[1]
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{name}: {H} heads, the kernel takes 1 to {MAX_HEADS}")
    if q.stride(-1) != 1 or ring.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    if pos.shape != (B,) or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be contiguous (B,) int32")
    _build.check_aligned(name, q, ring)
    out = torch.empty((B, H, LATENT), dtype=q.dtype, device=q.device)
    err = _build.load_library().repro_mla_decode(
        q.data_ptr(), ring.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, C,
        q.stride(0), q.stride(1), ring.stride(0), ring.stride(1), scale,
        _build.stream_ptr(q))
    _build.check(err, name)
    return out
