"""RWKV6 ("Finch") time-mix and channel-mix (``repro.models.rwkv``):
attention-free recurrence with data-dependent decay (arXiv:2404.05892).

The WKV recurrence runs through ``ops.wkv``: on the card the hand-written
Hopper kernel, on the CPU its plain version. The JAX model computes the
decode step's recurrence with einsums outside any kernel; here the decode
step goes through the same kernel with S = 1, updating the cache's state in
place. Training (``time_mix(..., is_train=True)``) runs the recurrence and
the per-head norm as the differentiable torch ops of ``wkv_plain`` and
``rmsnorm_plain`` on any device, the counterpart of JAX's ``lax.scan``
``wkv_scan``: the kernels have no backward.

Weights keep the JAX leaf names and (d_in, d_out) orientation, one dict per
layer. Rounding follows the JAX code exactly: everything up to the decay's
``float()`` rounds in the model dtype, the WKV output is cast to the model
dtype before its per-head norm, and the channel mix's squared ReLU and
sigmoid run in fp32 and are then cast.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_wkv import wkv_plain
from repro_torch.models.common import init_param, rms_norm

LORA_RANK = 32


def init_time_mix(cfg: ModelConfig, generator: torch.Generator,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's time-mix weights (``init_time_mix`` of the reference)."""
    d, dt = cfg.d_model, cfg.torch_dtype
    H, hd = cfg.n_ssm_heads, cfg.ssm.head_dim
    r = LORA_RANK

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    p: Dict[str, torch.Tensor] = {"w0": zeros(d)}
    for name in ("x", "w", "k", "v", "r", "g"):
        p[f"mu_{name}"] = zeros(d)
    for name in ("w", "k", "v", "r", "g"):
        p[f"la_{name}"] = init_param((d, r), generator, dt, device)
        p[f"lb_{name}"] = init_param((r, d), generator, dt, device, scale=0.1)
    for name in ("wr", "wk", "wv", "wg"):
        p[name] = init_param((d, H * hd), generator, dt, device)
    p["wo"] = init_param((H * hd, d), generator, dt, device,
                         scale=1.0 / max(cfg.n_layers, 1) ** 0.5)
    p["u"] = zeros(H, hd)
    p["ln_x"] = torch.ones((H * hd,), dtype=dt, device=device)
    return p


def init_channel_mix(cfg: ModelConfig, generator: torch.Generator,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's channel-mix weights (``init_channel_mix``)."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    return {
        "mu_k": torch.zeros((d,), dtype=dt, device=device),
        "mu_r": torch.zeros((d,), dtype=dt, device=device),
        "wk": init_param((d, f), generator, dt, device),
        "wv": init_param((f, d), generator, dt, device,
                         scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
        "wr": init_param((d, d), generator, dt, device),
    }


def _ddlerp(x, dx, mu, la, lb):
    """Data-dependent token-shift interpolation (rwkv6)."""
    return x + dx * (mu + torch.tanh((x + dx * mu) @ la) @ lb)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
             state_out: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence. r,k,v: (B,S,H,hd); w: (B,S,H,hd) fp32; u: (H,hd);
    s0: (B,H,hd,hd) fp32, or None for zeros.

    y_t = r_t . (S_{t-1} + u * k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    Returns (y (B,S,H,hd) in r's dtype, s_final fp32); ``state_out`` (which
    may be ``s0``) receives s_final in place.
    """
    return ops.wkv(r, k, v, w, u, s0=s0, state_out=state_out)


def _tm_inputs(p: Dict, x: torch.Tensor, xx: torch.Tensor, cfg: ModelConfig):
    """r,k,v,w,g from x and its token-shift xx; r,k,v,w are (B,S,H,hd),
    w in fp32, g (B,S,H*hd)."""
    H, hd = cfg.n_ssm_heads, cfg.ssm.head_dim
    dx = xx - x
    xw = _ddlerp(x, dx, p["mu_w"], p["la_w"], p["lb_w"])
    xk = _ddlerp(x, dx, p["mu_k"], p["la_k"], p["lb_k"])
    xv = _ddlerp(x, dx, p["mu_v"], p["la_v"], p["lb_v"])
    xr = _ddlerp(x, dx, p["mu_r"], p["la_r"], p["lb_r"])
    xg = _ddlerp(x, dx, p["mu_g"], p["la_g"], p["lb_g"])
    shp = x.shape[:-1] + (H, hd)
    r = (xr @ p["wr"]).view(shp)
    k = (xk @ p["wk"]).view(shp)
    v = (xv @ p["wv"]).view(shp)
    g = F.silu((xg @ p["wg"]).float()).to(x.dtype)
    # decay in (0,1), data-dependent; la_w serves xw above and the decay
    # here, as in the reference
    w = torch.exp(-torch.exp((torch.tanh(xw @ p["la_w"]) @ p["lb_w"]
                              + p["w0"]).float())).view(shp)
    return r, k, v, w, g


def _out(p: Dict, cfg: ModelConfig, y: torch.Tensor, g: torch.Tensor,
         dtype: torch.dtype, is_train: bool = False) -> torch.Tensor:
    """Per-head norm of the WKV output (a ones gain, then ``ln_x``), gated
    by g and projected by ``wo``."""
    B, S, H, hd = y.shape
    ones = torch.ones((hd,), dtype=dtype, device=y.device)
    y = rms_norm(y.to(dtype), ones, cfg.norm_eps,
                 is_train=is_train).view(B, S, H * hd) * p["ln_x"]
    return (y * g) @ p["wo"]


def time_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor, shift: torch.Tensor,
             state: Optional[torch.Tensor], *, is_train: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix. x: (B,S,D); shift: (B,D) last token of the
    previous segment; state: (B,H,hd,hd) fp32, or None for zeros. Returns
    (out, shift', state')."""
    xx = torch.cat([shift[:, None, :], x[:, :-1, :]], dim=1)
    r, k, v, w, g = _tm_inputs(p, x, xx, cfg)
    if is_train:
        y, s_final = wkv_plain(r, k, v, w, p["u"], state)
    else:
        y, s_final = wkv_scan(r, k, v, w, p["u"], state)
    return _out(p, cfg, y, g, x.dtype, is_train), x[:, -1, :], s_final


def time_mix_step(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                  shift: torch.Tensor, state: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode. x: (B,1,D); shift: (B,D); state: (B,H,hd,hd)
    fp32, updated IN PLACE (the JAX version returns a new state). Returns
    (out, shift', state)."""
    r, k, v, w, g = _tm_inputs(p, x, shift[:, None, :], cfg)
    y, state = wkv_scan(r, k, v, w, p["u"], state, state_out=state)
    return _out(p, cfg, y, g, x.dtype), x[:, 0, :], state


def channel_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix. x: (B,S,D); shift: (B,D)."""
    xx = torch.cat([shift[:, None, :], x[:, :-1, :]], dim=1)
    dx = xx - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    k = torch.square(F.relu((xk @ p["wk"]).float())).to(x.dtype)
    return (torch.sigmoid((xr @ p["wr"]).float()).to(x.dtype) * (k @ p["wv"]),
            x[:, -1, :])
