"""PyTorch/CUDA port of the ``repro`` model stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor JAX) and keeps its module names, so each counterpart is easy to find.

Device rule: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. With no CUDA and no explicit CPU request it raises; it
never carries on on the CPU by itself.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the CPU")
    return dev
