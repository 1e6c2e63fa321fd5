"""RMSNorm: the Hopper kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``). Bytes bound it on the H100 (one read and one write per
element); at serving shapes the launch does. The kernel takes one block per
row and reduces in fp32 with warp shuffles; see the source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_plain(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in fp32, cast to x's dtype, then multiply by the gain."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gain


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); gain: (d,). CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if _build.use_plain("rmsnorm", x, gain):
        return rmsnorm_plain(x, gain, eps)
    code = _build.dtype_code("rmsnorm", x, gain)
    d = x.shape[-1]
    if gain.shape != (d,) or not gain.is_contiguous():
        raise ValueError(f"rmsnorm: gain must be contiguous ({d},), got "
                         f"{tuple(gain.shape)}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.repro_rmsnorm(x.data_ptr(), gain.data_ptr(), out.data_ptr(),
                            rows, d, float(eps), code, _build.stream_ptr(x))
    _build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
