"""Mesh construction (``repro.launch.mesh``).

Functions, not module-level constants, so importing this module touches no
device. The production meshes are logical: their shape and axis names
derive sharding specs and transition plans, and placing onto them raises.
Single pod: 16x16 = 256 chips (data x model); multi-pod: 2x16x16 = 512
chips with a leading "pod" axis.
"""
from __future__ import annotations

from repro_torch import resolve_device
from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_local_mesh(device=None) -> Mesh:
    """A ("data",) mesh over the one device ``resolve_device`` gives
    (``cuda`` unless ``device`` says otherwise)."""
    return Mesh({"data": 1}, devices=[resolve_device(device)])
