"""Bring JAX-initialised weights into the port.

``params_from_numpy`` takes the JAX parameter tree as numpy arrays (what
``unbox(init_model(...))[0]`` gives after ``np.asarray`` on every leaf) and
returns the port's parameter dict. Layer-stacked leaves such as
``dec/attn/wq`` of shape (L, d, hq*hd) become layer ``l``'s ``attn/wq``,
and likewise ``dec/tm/*`` and ``dec/cm/*`` for the ssm family (rwkv6).
bf16 comes across through float32, which is exact in both directions. Any
tree of the params' structure comes across the same way: a gradient tree,
or with ``dtype=torch.float32`` the fp32 optimizer moments.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)   # bf16 (ml_dtypes) -> f32 is exact
    return torch.tensor(arr).to(dtype=dtype, device=device)


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The port's parameters from the JAX dense- or ssm-family tree, in
    ``dtype`` (``cfg``'s model dtype unless given)."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)
    dt = cfg.torch_dtype if dtype is None else dtype
    dec = tree["dec"]
    p: Dict = {
        "embed": _tensor(tree["embed"], dt, dev),
        "final_norm": _tensor(tree["final_norm"], dt, dev),
    }
    if "unembed" in tree:
        p["unembed"] = _tensor(tree["unembed"], dt, dev)
    groups = ("tm", "cm") if cfg.family == "ssm" else ("attn", "mlp")
    layers = []
    for l in range(cfg.n_layers):
        lp = {"norm1": _tensor(dec["norm1"][l], dt, dev),
              "norm2": _tensor(dec["norm2"][l], dt, dev)}
        for grp in groups:
            lp[grp] = {k: _tensor(v[l], dt, dev) for k, v in dec[grp].items()}
        layers.append(lp)
    p["layers"] = layers
    return p
