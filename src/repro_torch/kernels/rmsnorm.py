"""RMSNorm: the Hopper kernel ``csrc/rmsnorm.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py`` (``rmsnorm`` /
``_rmsnorm_kernel``). Bytes bound it on the H100 (one read and one write per
element); at serving shapes latency does: the launch, one memory round trip,
the reduction and one store. The kernel gives each row a group of lanes
that load it once, 16 bytes at a time, keep it in registers and reduce with
warp shuffles; see the source for the design and ``geometry`` for the
partition.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

BLOCK_THREADS = 128        # a block packs BLOCK_THREADS // lanes rows
MAX_LANES = 512
MAX_LOADS = {True: 4, False: 16}   # loads a lane holds: 16-byte, or scalar


class Geometry(NamedTuple):
    vec: int             # elements per load: 16 bytes' worth, or 1 (scalar)
    lanes: int           # threads per row, a power of two
    loads: int           # loads per lane (0: the row is too wide; refused)
    rows_per_block: int
    threads: int         # per block
    blocks: int


def geometry(rows: int, d: int, elem_bytes: int, aligned: bool = True) -> Geometry:
    """The launch geometry of ``repro_rmsnorm``. The C++ ``geometry`` in
    ``csrc/rmsnorm.cu`` decides the launch; this mirrors it for the tests,
    and chip_smoke.py holds the two equal through ``repro_rmsnorm_geometry``.
    ``aligned``: x, the gain and the output all start on 16 bytes."""
    v16 = 16 // elem_bytes
    vec = v16 if aligned and d % v16 == 0 else 1
    chunks = d // vec
    max_loads = MAX_LOADS[vec > 1]
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    while -(-chunks // lanes) > max_loads and lanes < MAX_LANES:
        lanes *= 2
    loads = -(-chunks // lanes)
    if loads > max_loads:
        loads = 0
    rpb = 1 if lanes >= BLOCK_THREADS else BLOCK_THREADS // lanes
    return Geometry(vec, lanes, loads, rpb, rpb * lanes, -(-rows // rpb))


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
    out = torch.empty_like(x)
    aligned = (x.data_ptr() | gain.data_ptr() | out.data_ptr()) % 16 == 0
    if d and geometry(1, d, x.element_size(), aligned).loads == 0:
        raise ValueError(f"rmsnorm: d = {d} is too wide for a row in registers")
    rows = x.numel() // d if d else 0
    lib = _build.load_library()
    err = lib.repro_rmsnorm(x.data_ptr(), gain.data_ptr(), out.data_ptr(),
                            rows, d, float(eps), code, _build.stream_ptr(x))
    _build.check(err, "rmsnorm")
    return out
