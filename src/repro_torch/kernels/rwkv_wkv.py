"""RWKV6 WKV recurrence: the Hopper kernel ``csrc/rwkv_wkv.cu`` and its
plain version.

Replaces the TPU kernel ``repro/kernels/rwkv_wkv.py`` (``wkv`` /
``_wkv_kernel``). For each (b, h) the fp32 hd x hd state S runs over time:

    y_t = r_t (S + u * k_t^T v_t);   S <- diag(w_t) S + k_t^T v_t

At a decode step bytes bound it on the H100 (the fp32 state is read and
written once); at prefill the sequential time loop's latency does. The
kernel is built at head dims ``HEAD_DIMS``. It splits each (b, h) over
``COL_BLOCKS[hd]`` blocks of 16 columns and each column over
``ROW_LANES[hd]`` lanes of rows, keeps the state in registers, and stages
r/k/w/v ``CHUNK_STEPS`` time steps at a time in shared memory, one chunk in
flight while the previous one is computed. A decode step (S = 1) takes a
kernel of its own that loads straight into registers, min(32, hd) columns
a warp; see the source.

The interface is the model's (``repro.models.rwkv.wkv_scan``), not the TPU
kernel's: r/k/v/w are (B,S,H,hd), of which the TPU kernel's (B,H,S,hd) is a
transposed view, so nothing is transposed per call.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# the head dims the kernel is built for: 64 (rwkv6-7b), 16 (its reduced
# config), 32; each one is built and checked
HEAD_DIMS = (16, 32, 64)
# The kernel's partition per head dim (csrc/rwkv_wkv.cu decides it; the
# tests replay it): blocks per (b, h) at a prefill, 16 state columns each;
# lanes per column, hd // 4 state rows each
COL_BLOCKS = {hd: hd // 16 for hd in HEAD_DIMS}
ROW_LANES = {hd: 4 for hd in HEAD_DIMS}
# time steps staged at a time at a prefill (a decode step, S = 1, stages none)
CHUNK_STEPS = {torch.bfloat16: 32, torch.float32: 16}


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Python loop over t of fp32 einsums (``repro.kernels.ref.ref_wkv``
    with an initial state). r/k/v/w: (B,S,H,hd); u: (H,hd); s0: (B,H,hd,hd)
    or None for zeros. Returns y (B,S,H,hd) in r's dtype and the final state
    (B,H,hd,hd) in fp32."""
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    uf = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
        kv = torch.einsum("bhi,bhj->bhij", kt, vt)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, s + uf * kv))
        s = wt[..., None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, *, s0: Optional[torch.Tensor] = None,
        state_out: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: (B,S,H,hd) in the model dtype and w: (B,S,H,hd) fp32, any
    16-byte aligned strides with a contiguous last dimension (on the card);
    u: (H,hd) in the model dtype, 16-byte aligned;
    s0: (B,H,hd,hd) fp32 or None (zeros). Returns (y (B,S,H,hd) in r's
    dtype, final state fp32). The final state is written to ``state_out``
    when given, which may be ``s0`` itself (an in-place update). CPU tensors
    take the plain version, CUDA tensors the kernel."""
    tensors = [r, k, v, w, u] + [t for t in (s0, state_out) if t is not None]
    if _build.use_plain("wkv", *tensors):
        y, s = wkv_plain(r, k, v, w, u, s0)
        if state_out is not None:
            state_out.copy_(s)
            s = state_out
        return y, s
    code = _build.dtype_code("wkv", r, k, v, u)
    B, S, H, hd = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"wkv: r/k/v/w shapes differ: {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv: head dim {hd} not in {HEAD_DIMS}")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv: w must be float32, got {w.dtype}")
    if u.shape != (H, hd) or not u.is_contiguous():
        raise ValueError(f"wkv: u must be contiguous ({H},{hd}), got "
                         f"{tuple(u.shape)}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("wkv: last dimension must be contiguous")
    _build.check_aligned("wkv", r, k, v, w, u)  # rows move 16 bytes at a time
    for name, t in (("s0", s0), ("state_out", state_out)):
        if t is not None and (t.shape != (B, H, hd, hd)
                              or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"wkv: {name} must be contiguous ({B},{H},{hd},"
                             f"{hd}) float32")
    y = torch.empty((B, S, H, hd), dtype=r.dtype, device=r.device)
    s_out = state_out if state_out is not None else torch.empty(
        (B, H, hd, hd), dtype=torch.float32, device=r.device)
    lib = _build.load_library()
    err = lib.repro_wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        B, H, S, hd,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        code, _build.stream_ptr(r))
    _build.check(err, "wkv")
    return y, s_out
