"""Mamba-style selective-SSM heads for the hybrid (hymba) family
(``repro.models.mamba``).

Hymba runs attention heads and SSM heads in parallel inside each layer
(arXiv:2411.13676); this module is the SSM half. Per head of dim ``hd``
with state width ``N``:

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * (z_t  (x)  B_t)
    y_t = S_t @ C_t + D_h * z_t

with data-dependent dt (softplus), B, C and a short causal conv on the
input. The scan is a sequential fp32 loop in torch ops: the reference's
64-step chunks are rematerialisation for the backward and do not change
the numbers, and it has no Pallas kernel for the scan.

Where torch and JAX would otherwise differ:
- ``_conv1d`` sums the ``cw`` shifted products in x's dtype in Python
  ``sum`` order, as the reference does (bf16 rounds at every add);
- SiLU runs in fp32 and is cast back;
- softplus is ``logaddexp(x, 0)``, as JAX's: ``F.softplus`` switches to
  the identity above 20.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import init_param

def init_mamba(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's SSM heads: ``b_dt`` and ``a_log`` start at zero (A = -1),
    ``d_skip`` at one, the conv at scale 0.5."""
    d, dt = cfg.d_model, cfg.torch_dtype
    H, hd, N = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.state_size
    cw = max(cfg.ssm.conv_width, 1)
    return {
        "w_in": init_param((d, H * hd), generator, dt, device),
        "w_dt": init_param((d, H), generator, dt, device),
        "b_dt": torch.zeros((H,), dtype=dt, device=device),
        "w_B": init_param((d, H * N), generator, dt, device),
        "w_C": init_param((d, H * N), generator, dt, device),
        "a_log": torch.zeros((H,), dtype=dt, device=device),
        "d_skip": torch.ones((H,), dtype=dt, device=device),
        "conv": init_param((cw, H * hd), generator, dt, device, scale=0.5),
        "w_out": init_param((H * hd, d), generator, dt, device,
                            scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }


def _conv1d(z: torch.Tensor, w: torch.Tensor,
            carry: Optional[torch.Tensor] = None):
    """Causal depthwise conv. z: (B,S,C); w: (cw,C); carry: (B,cw-1,C).
    Returns (out (B,S,C), the new carry: the last cw-1 inputs)."""
    cw = w.shape[0]
    if cw == 1:
        return z * w[0], None
    if carry is None:
        carry = torch.zeros((z.shape[0], cw - 1, z.shape[2]), dtype=z.dtype,
                            device=z.device)
    zp = torch.cat([carry, z], dim=1)
    S = z.shape[1]
    out = sum(zp[:, i:i + S, :] * w[i] for i in range(cw))
    return out, zp[:, -(cw - 1):, :]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) with no threshold: ``jax.nn.softplus``, which is
    ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_inputs(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                conv_carry: Optional[torch.Tensor] = None):
    H, hd, N = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.state_size
    B, S, _ = x.shape
    z = x @ p["w_in"]
    z, conv_carry = _conv1d(z, p["conv"], conv_carry)
    z = F.silu(z.float()).to(x.dtype).reshape(B, S, H, hd)
    dt = softplus((x @ p["w_dt"] + p["b_dt"]).float())       # (B,S,H)
    a = -torch.exp(p["a_log"].float())                       # (H,)
    decay = torch.exp(dt * a)                                # (B,S,H)
    Bt = (x @ p["w_B"]).reshape(B, S, H, N)
    Ct = (x @ p["w_C"]).reshape(B, S, H, N)
    return z, dt, decay, Bt, Ct, conv_carry


def _update(z, dt, Bt):
    """The state increment dt * (z (x) B) in fp32: (..., hd, N)."""
    return (z * dt[..., None]).float()[..., :, None] * Bt.float()[..., None, :]


def ssm_scan(z, dt, decay, Bt, Ct, s0: torch.Tensor):
    """z: (B,S,H,hd); dt/decay: (B,S,H); Bt/Ct: (B,S,H,N); s0: (B,H,hd,N).
    Returns (y (B,S,H,hd) in z's dtype, final state fp32).

    What does not depend on the state is computed for all steps at once:
    the increments before the loop, and y from the stacked states after
    it, so each step is one ``addcmul``: S_t = upd_t + decay_t * S_{t-1}.
    """
    upd = _update(z, dt, Bt)                                 # (B,S,H,hd,N)
    dec = decay.float()[..., None, None]                     # (B,S,H,1,1)
    s, states = s0.float(), []
    for t in range(z.shape[1]):
        s = torch.addcmul(upd[:, t], dec[:, t], s)
        states.append(s)
    y = torch.matmul(torch.stack(states, dim=1), Ct.float()[..., None])[..., 0]
    return y.to(z.dtype), s


def mamba_mix(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: torch.Tensor):
    """Full-sequence SSM heads. x: (B,S,D); state: (B,H,hd,N) fp32.
    Returns (out, s_final, conv_carry)."""
    B, S, _ = x.shape
    H, hd = cfg.n_ssm_heads, cfg.ssm.head_dim
    z, dt, decay, Bt, Ct, conv_carry = _ssm_inputs(p, cfg, x)
    y, s_final = ssm_scan(z, dt, decay, Bt, Ct, state)
    y = y + p["d_skip"][None, None, :, None].to(y.dtype) * z
    return y.reshape(B, S, H * hd) @ p["w_out"], s_final, conv_carry


def mamba_step(p: Dict, cfg: ModelConfig, x: torch.Tensor, state: torch.Tensor,
               conv_carry: Optional[torch.Tensor]):
    """Single-token decode. x: (B,1,D); state: (B,H,hd,N) fp32;
    conv_carry: (B,cw-1,H*hd). Returns (out, state', conv_carry')."""
    B = x.shape[0]
    H, hd = cfg.n_ssm_heads, cfg.ssm.head_dim
    z, dt, decay, Bt, Ct, conv_carry = _ssm_inputs(p, cfg, x, conv_carry)
    zt = z[:, 0]
    state = torch.addcmul(_update(zt, dt[:, 0], Bt[:, 0]),
                          decay[:, 0].float()[..., None, None], state)
    yt = torch.matmul(state, Ct[:, 0].float()[..., None])[..., 0].to(x.dtype)
    yt = yt + p["d_skip"][None, :, None].to(yt.dtype) * zt
    return yt.reshape(B, 1, H * hd) @ p["w_out"], state, conv_carry
