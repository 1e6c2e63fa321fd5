"""Dense SwiGLU / GELU FFN (``repro.models.mlp_moe.mlp``); MoE is not
ported yet. Weights keep the JAX (d_in, d_out) orientation."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import init_param, swiglu


def init_mlp(cfg: ModelConfig, generator: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    p = {
        "w_up": init_param((d, f), generator, dt, device),
        "w_down": init_param((f, d), generator, dt, device,
                             scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }
    if cfg.act == "swiglu":
        p["w_gate"] = init_param((d, f), generator, dt, device)
    return p


def mlp(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.act == "swiglu":
        h = swiglu(x @ p["w_gate"], up)
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]
