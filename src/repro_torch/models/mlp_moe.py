"""Dense FFN (SwiGLU / GELU) and the Mixture-of-Experts block
(``repro.models.mlp_moe``). Weights keep the JAX (d_in, d_out) orientation.

The MoE block keeps the reference's GShard capacity-based dense dispatch:
tokens are folded into groups, a (group, token, expert, capacity) dispatch
tensor routes each token's top-k experts into per-expert buffers, and the
expert FFNs run as batched products over (expert, capacity). Which tokens
are dropped depends on the batch shape, exactly as in JAX. The products are
torch matmuls, as the reference leaves them to XLA (no Pallas kernel).

Where torch and JAX would otherwise differ:
- top-k: ``jax.lax.top_k`` puts the lower expert first among equal logits;
  ``torch.topk`` promises no order, so experts are picked by a stable
  descending sort and the gate values gathered from the logits;
- the router product runs in x's dtype and is cast to fp32 after, as in
  JAX, so bf16 routing picks the reference's experts;
- dispatch and combine are cast to x's dtype before the products (the gate
  weights are rounded to bf16 in a bf16 model).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import init_param, swiglu

CAPACITY_FACTOR = 1.25
GROUP_TOKENS = 1024


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


def _init_experts(shape, generator: torch.Generator, dtype: torch.dtype,
                  device: torch.device, scale: float = 1.0) -> torch.Tensor:
    """An (E, d_in, d_out) expert leaf drawn one expert at a time into a
    tensor of the model dtype: fan_in is d_in, as for the whole leaf, and
    the fp32 transient is one expert's (llama4's 128 experts at once would
    need ~54 GB of it per layer)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        out[e] = init_param(shape[1:], generator, dtype, device, scale=scale)
    return out


def init_moe(cfg: ModelConfig, generator: torch.Generator,
             device: torch.device) -> Dict[str, torch.Tensor]:
    """One MoE layer: the router (D, E), the experts ``we_gate``/``we_up``
    (E, D, F) and ``we_down`` (E, F, D), and with shared experts
    ``ws_gate``/``ws_up`` (D, s*F) and ``ws_down`` (s*F, D)."""
    d, f, e, dt = cfg.d_model, cfg.d_ff, cfg.moe.n_experts, cfg.torch_dtype
    p = {
        "router": init_param((d, e), generator, dt, device),
        "we_gate": _init_experts((e, d, f), generator, dt, device),
        "we_up": _init_experts((e, d, f), generator, dt, device),
        "we_down": _init_experts((e, f, d), generator, dt, device,
                                 scale=1.0 / max(cfg.n_layers, 1) ** 0.5),
    }
    if cfg.moe.n_shared_experts:
        s = cfg.moe.n_shared_experts
        p["ws_gate"] = init_param((d, s * f), generator, dt, device)
        p["ws_up"] = init_param((d, s * f), generator, dt, device)
        p["ws_down"] = init_param((s * f, d), generator, dt, device)
    return p


def moe_capacity(cfg: ModelConfig, group_tokens: int) -> int:
    mc = cfg.moe
    # dropless for small groups (decode steps): capacity covers the worst
    # case so no token is ever dropped at generation time
    if group_tokens * mc.top_k <= 64:
        return group_tokens * mc.top_k
    c = int(group_tokens * mc.top_k * CAPACITY_FACTOR / mc.n_experts)
    return max(c, mc.top_k)


def _top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, the lower
    index first among equals (``jax.lax.top_k``'s order)."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(logits, -1, idx), idx


def _routing(p: Dict, cfg: ModelConfig, xg: torch.Tensor):
    """dispatch/combine tensors (G,T,E,C) fp32 and the router logits
    (G,T,E) fp32 from grouped tokens xg (G,T,D)."""
    mc = cfg.moe
    G, T, _ = xg.shape
    E, K = mc.n_experts, mc.top_k
    C = moe_capacity(cfg, T)
    logits = (xg @ p["router"]).float()
    gate_vals, idx = _top_k(logits, K)                       # (G,T,K)
    gate_vals = torch.softmax(gate_vals, dim=-1)
    onehot = F.one_hot(idx, E).float()                       # (G,T,K,E)
    # position of each (token, k) inside its expert buffer: a cumsum over
    # the k-major order, so every first choice outranks every second
    flat = onehot.transpose(1, 2).reshape(G, K * T, E)
    pos_flat = (torch.cumsum(flat, dim=1) - 1.0) * flat
    pos = pos_flat.reshape(G, K, T, E).transpose(1, 2)       # (G,T,K,E)

    dispatch = torch.zeros((G, T, E, C), dtype=torch.float32, device=xg.device)
    combine = torch.zeros_like(dispatch)
    for k in range(K):
        oh_e = onehot[:, :, k, :]                            # (G,T,E)
        pos_t = torch.sum(pos[:, :, k, :] * oh_e, dim=-1)    # (G,T)
        keep = (pos_t < C).float()
        # a dropped token's one-hot row is zeroed by keep (JAX's one_hot
        # gives zeros for an index >= C; F.one_hot would raise)
        oh_c = F.one_hot(pos_t.long().clamp(max=C - 1), C).float()  # (G,T,C)
        d_k = (oh_e * keep[..., None])[..., :, None] * oh_c[..., None, :]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_vals[:, :, k, None, None]
    return dispatch, combine, logits


def _experts(p: Dict, xe: torch.Tensor) -> torch.Tensor:
    """The expert FFNs on their buffers xe (G,E,C,D) -> (G,E,C,D), as one
    batched product per matrix over the experts (the weights are read in
    place, never copied)."""
    G, E, C, D = xe.shape
    xb = xe.transpose(0, 1).reshape(E, G * C, D)
    h = swiglu(torch.bmm(xb, p["we_gate"]), torch.bmm(xb, p["we_up"]))
    return torch.bmm(h, p["we_down"]).reshape(E, G, C, D).transpose(0, 1)


def moe(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Top-k routed experts, capacity-based dispatch. x: (B,S,D). Tokens
    form groups of GROUP_TOKENS when their count divides by it, else one
    group."""
    B, S, D = x.shape
    tokens = B * S
    T = GROUP_TOKENS if tokens % GROUP_TOKENS == 0 else tokens
    G = tokens // T
    xg = x.reshape(G, T, D)
    dispatch, combine, _ = _routing(p, cfg, xg)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)        # (G,E,C,D)
    with tracing.span("moe.experts"):
        ye = _experts(p, xe)
    out = torch.einsum("gecd,gtec->gtd", ye, combine).reshape(B, S, D)
    if cfg.moe.n_shared_experts:
        out = out + swiglu(x @ p["ws_gate"], x @ p["ws_up"]) @ p["ws_down"]
    return out


def moe_aux_loss(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss (fp32 scalar)."""
    mc = cfg.moe
    logits = (x @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    _, idx = _top_k(logits, mc.top_k)
    frac = F.one_hot(idx, mc.n_experts).float().mean(dim=(0, 1, 2))
    imp = probs.mean(dim=(0, 1))
    return mc.n_experts * torch.sum(frac * imp)
