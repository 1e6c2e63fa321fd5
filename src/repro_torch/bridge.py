"""Move weights between the port's layout and the JAX package's.

``params_from_numpy`` takes the JAX parameter tree as numpy arrays (what
``unbox(init_model(...))[0]`` gives after ``np.asarray`` on every leaf) and
returns the port's parameter dict. Layer-stacked leaves such as
``dec/attn/wq`` of shape (L, d, hq*hd) become layer ``l``'s ``attn/wq``,
and likewise ``dec/ssm/*`` (the hybrid family's Mamba heads) and
``dec/tm/*`` and ``dec/cm/*`` for the ssm family (rwkv6). The MoE family
stacks its FFNs by kind: with super-layers of k = ``moe.interleave``
layers, ``dec/moe/*`` has one entry per super-layer s, layer s*k + k-1,
and ``dec/mlp/*`` one per dense layer, in layer order (JAX regroups it as
(n_super, k-1)), so dense entry s*(k-1) + j is layer s*k + j. The encdec
family's ``enc/*`` (stacked over its encoder layers, beside
``enc/final_norm``) becomes ``enc["layers"][l]`` and ``enc["final_norm"]``;
``dec/cross`` and ``dec/norm3`` go to each decoder layer like ``dec/attn``;
``frame_proj`` and ``patch_proj`` stay at the top. bf16 comes across through float32, which is exact in both directions. Any
tree of the params' structure comes across the same way: a gradient tree,
or with ``dtype=torch.float32`` the fp32 optimizer moments.

``to_jax_layout`` is the inverse on tensors: it stacks layer ``l``'s
``attn/wq`` back into ``dec/attn/wq`` with a leading L, and
``from_jax_layout`` takes a tree of that layout (a restored checkpoint) to
the port's again, with each layer a view of the stacked tensor. Both keep
dtypes (bf16 stays bf16) and devices. ``param_shapes`` and ``param_axes``
give the JAX layout's shapes and logical sharding axes, what
``unbox(init_model(Init(..., abstract=True), cfg))`` gives, from the config
alone.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.rwkv import LORA_RANK


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype != np.float32:
        arr = arr.astype(np.float32)   # bf16 (ml_dtypes) -> f32 is exact
    return torch.tensor(arr).to(dtype=dtype, device=device)


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The port's parameters from the JAX tree, in ``dtype`` (``cfg``'s
    model dtype unless given)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype if dtype is None else dtype
    return from_jax_layout(_dict_map(lambda a: _tensor(a, dt, dev), tree), cfg)


def _stack_layers(layers) -> Dict:
    """Per-layer dicts stacked along a new leading dim, each kind of leaf
    over the layers that have it, in layer order."""
    kinds = {k: v for lp in layers for k, v in lp.items()}
    out = {}
    for k, v in kinds.items():
        have = [lp[k] for lp in layers if k in lp]
        out[k] = ({n: torch.stack([t[n] for t in have]) for n in v}
                  if isinstance(v, dict) else torch.stack(have))
    return out


def to_jax_layout(params: Mapping, cfg: ModelConfig) -> Dict:
    """A tree of the port's params structure (params, gradients or a
    moment) in the JAX layout: ``layers`` stacked into ``dec`` and the
    encoder's layers into ``enc``."""
    out = {k: v for k, v in params.items() if k not in ("layers", "enc")}
    out["dec"] = _stack_layers(params["layers"])
    if "enc" in params:
        out["enc"] = dict(_stack_layers(params["enc"]["layers"]),
                          final_norm=params["enc"]["final_norm"])
    return out


def _stack_index(cfg: ModelConfig):
    """For each layer, its index into each kind's stack: the layer itself,
    or for ``moe`` and ``mlp`` of a MoE config the count of earlier layers
    of the same kind."""
    mask = cfg.moe_layer_mask()
    for l, is_moe in enumerate(mask):
        if cfg.moe is None:
            yield {"moe": None, "mlp": l}
        else:
            n_moe = sum(mask[:l])
            yield {"moe": n_moe, "mlp": None} if is_moe else \
                {"moe": None, "mlp": l - n_moe}


def _split_layers(stacked: Mapping, owners) -> list:
    """The inverse of ``_stack_layers``: for each layer's ``own`` (a kind's
    index into its stack, None where the layer has none, the layer itself
    where not named), the layer's views of the stacked tensors."""
    layers = []
    for l, own in enumerate(owners):
        lp = {}
        for k, v in stacked.items():
            i = own.get(k, l)
            if i is not None:
                lp[k] = ({n: t[i] for n, t in v.items()}
                         if isinstance(v, dict) else v[i])
        layers.append(lp)
    return layers


def from_jax_layout(tree: Mapping, cfg: ModelConfig) -> Dict:
    """The inverse of ``to_jax_layout``: ``dec`` split into ``layers`` and
    ``enc`` into its ``layers`` and ``final_norm``, each a view of the
    stacked tensors."""
    out = {k: v for k, v in tree.items() if k not in ("dec", "enc")}
    out["layers"] = _split_layers(tree["dec"], _stack_index(cfg))
    if "enc" in tree:
        enc = {k: v for k, v in tree["enc"].items() if k != "final_norm"}
        out["enc"] = {"layers": _split_layers(
            enc, [{}] * cfg.n_encoder_layers),
            "final_norm": tree["enc"]["final_norm"]}
    return out


def _param_specs(cfg: ModelConfig) -> Dict:
    """(shape, axes) of every leaf of the JAX layout, as the reference's
    ``init_model``, ``init_attention``, ``init_mlp``, ``init_moe``,
    ``init_mamba``, ``init_time_mix`` and ``init_channel_mix`` declare
    them."""
    L, D, V, F = cfg.n_layers, cfg.d_model, cfg.padded_vocab, cfg.d_ff
    LE = ("layers", "embed")
    p = {"embed": ((V, D), ("vocab", "embed")), "final_norm": ((D,), ("embed",))}
    if not cfg.tie_embeddings:
        p["unembed"] = ((D, V), ("embed", "vocab"))
    dec: Dict = {"norm1": ((L, D), LE), "norm2": ((L, D), LE)}
    if cfg.family == "ssm":
        H, hd, r = cfg.n_ssm_heads, cfg.ssm.head_dim, LORA_RANK
        tm: Dict = {"w0": ((L, D), LE)}
        for n in ("x", "w", "k", "v", "r", "g"):
            tm[f"mu_{n}"] = ((L, D), LE)
        for n in ("w", "k", "v", "r", "g"):
            tm[f"la_{n}"] = ((L, D, r), LE + ("lora",))
            tm[f"lb_{n}"] = ((L, r, D), ("layers", "lora", "embed"))
        for n in ("wr", "wk", "wv", "wg"):
            tm[n] = ((L, D, H * hd), LE + ("ssm_dim",))
        tm["wo"] = ((L, H * hd, D), ("layers", "ssm_dim", "embed"))
        tm["u"] = ((L, H, hd), ("layers", "", ""))
        tm["ln_x"] = ((L, H * hd), ("layers", "ssm_dim"))
        dec["tm"] = tm
        dec["cm"] = {"mu_k": ((L, D), LE), "mu_r": ((L, D), LE),
                     "wk": ((L, D, F), LE + ("mlp",)),
                     "wv": ((L, F, D), ("layers", "mlp", "embed")),
                     "wr": ((L, D, D), LE + ("act_embed",))}
    else:
        dec["attn"] = _attn_specs(cfg, L)
        if cfg.family == "hybrid":
            H, shd, N = cfg.n_ssm_heads, cfg.ssm.head_dim, cfg.ssm.state_size
            cw = max(cfg.ssm.conv_width, 1)
            dec["ssm"] = {
                "w_in": ((L, D, H * shd), LE + ("ssm_dim",)),
                "w_dt": ((L, D, H), LE + ("",)),
                "b_dt": ((L, H), ("layers", "")),
                "w_B": ((L, D, H * N), LE + ("",)),
                "w_C": ((L, D, H * N), LE + ("",)),
                "a_log": ((L, H), ("layers", "")),
                "d_skip": ((L, H), ("layers", "")),
                "conv": ((L, cw, H * shd), ("layers", "conv", "ssm_dim")),
                "w_out": ((L, H * shd, D), ("layers", "ssm_dim", "embed"))}
        n_moe = L // cfg.moe.interleave if cfg.moe else 0
        if L - n_moe:
            dec["mlp"] = _mlp_specs(cfg, L - n_moe)
        if n_moe:
            E, LX = cfg.moe.n_experts, ("layers", "experts")
            moe = {"router": ((n_moe, D, E), LE + ("experts",)),
                   "we_gate": ((n_moe, E, D, F), LX + ("embed", "mlp")),
                   "we_up": ((n_moe, E, D, F), LX + ("embed", "mlp")),
                   "we_down": ((n_moe, E, F, D), LX + ("mlp", "embed"))}
            if cfg.moe.n_shared_experts:
                sf = cfg.moe.n_shared_experts * F
                moe["ws_gate"] = moe["ws_up"] = ((n_moe, D, sf), LE + ("mlp",))
                moe["ws_down"] = ((n_moe, sf, D), ("layers", "mlp", "embed"))
            dec["moe"] = moe
    if cfg.is_encdec:
        dec["cross"] = _attn_specs(cfg, L, cross=True)
        dec["norm3"] = ((L, D), LE)
        Le = cfg.n_encoder_layers
        p["enc"] = {"attn": _attn_specs(cfg, Le), "mlp": _mlp_specs(cfg, Le),
                    "norm1": ((Le, D), LE), "norm2": ((Le, D), LE),
                    "final_norm": ((D,), ("embed",))}
    p["dec"] = dec
    if cfg.frontend == "audio_frames":
        p["frame_proj"] = ((D, D), ("embed", "act_embed"))
    if cfg.frontend == "vision_patches":
        p["patch_proj"] = ((D, D), ("embed", "act_embed"))
    return p


def _attn_specs(cfg: ModelConfig, n: int, cross: bool = False) -> Dict:
    """``init_attention``'s leaves over n stacked layers; a ``cross`` layer
    has no bias or qk_norm."""
    D, hq, hd, kv = cfg.d_model, cfg.n_attn_heads, cfg.head_dim_, cfg.n_kv_heads
    LE = ("layers", "embed")
    attn = {"wq": ((n, D, hq * hd), LE + ("heads",)),
            "wk": ((n, D, kv * hd), LE + ("kv",)),
            "wv": ((n, D, kv * hd), LE + ("kv",)),
            "wo": ((n, hq * hd, D), ("layers", "heads", "embed"))}
    if cfg.qkv_bias and not cross:
        attn["bq"] = ((n, hq * hd), ("layers", "heads"))
        attn["bk"] = attn["bv"] = ((n, kv * hd), ("layers", "kv"))
    if cfg.qk_norm and not cross:
        attn["q_norm"] = attn["k_norm"] = ((n, hd), ("layers", ""))
    return attn


def _mlp_specs(cfg: ModelConfig, n: int) -> Dict:
    """``init_mlp``'s leaves over n stacked layers."""
    D, F, LE = cfg.d_model, cfg.d_ff, ("layers", "embed")
    mlp = {"w_up": ((n, D, F), LE + ("mlp",)),
           "w_down": ((n, F, D), ("layers", "mlp", "embed"))}
    if cfg.act == "swiglu":
        mlp["w_gate"] = ((n, D, F), LE + ("mlp",))
    return mlp


def _dict_map(fn, tree: Mapping) -> Dict:
    """fn over the leaves of a tree of nested dicts."""
    return {k: _dict_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def param_shapes(cfg: ModelConfig) -> Dict:
    """The shape of every leaf of the JAX layout, from ``cfg`` alone."""
    return _dict_map(lambda s: s[0], _param_specs(cfg))


def param_axes(cfg: ModelConfig) -> Dict:
    """The logical axes of every leaf of the JAX layout (the axes tree of
    ``unbox(init_model(...))``), from ``cfg`` alone."""
    return _dict_map(lambda s: s[1], _param_specs(cfg))
