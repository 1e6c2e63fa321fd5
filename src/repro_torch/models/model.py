"""Every family of the reference's decoder and its serving steps
(``repro.models.model``): dense, MoE, hybrid (attention + Mamba heads),
rwkv6 (ssm), the encoder-decoder (encdec) and the decoder that takes image
patches (vlm).

Parameters are a plain dict: ``embed`` (padded_vocab, D), ``final_norm``
(D,), optionally ``unembed`` (D, padded_vocab), and ``layers``, a list with
one dict per layer: ``norm1``, ``norm2`` and the ``attn`` weights with
either the dense ``mlp`` or, on a layer of ``cfg.moe_layer_mask()`` (the
last sublayer of each super-layer of ``moe.interleave`` layers), the
``moe`` weights; the hybrid family adds ``ssm`` (Mamba heads) to every
layer; the ssm family has the ``tm`` (time-mix) and ``cm`` (channel-mix)
weights instead. The encdec family adds ``cross`` (cross-attention, no
bias or qk_norm) and ``norm3`` to every decoder layer, ``enc`` ({"layers":
[{"attn", "mlp", "norm1", "norm2"}, ...], "final_norm"}) and the frame
projection ``frame_proj`` (D, D); the vlm family adds ``patch_proj`` (D,
D). A Python loop over ``layers`` takes the place of JAX's ``lax.scan``
over (super-)layers. A latent-attention model (``cfg.is_mla``, the port's
own: DeepSeek-V2) has the ``attn`` weights of ``attention.init_mla``, its
leading ``moe.n_dense_layers`` layers dense and the rest MoE, and one ring
``latent`` (L,B,C,r + rope) in place of ``k``/``v``: prefill writes each
token's [normed latent | roped k_rope], a decode step the new token's.

    init_model(cfg, generator, device)          -> params
    forward(cfg, params, batch)                 -> final hidden states
    loss_fn(cfg, params, batch)                 -> (scalar, metrics)
    prefill_step(cfg, params, batch, ...)       -> (cache, last-token logits)
    decode_step(cfg, params, tokens, cache)     -> (logits, cache)

A batch holds ``tokens`` (B,S) int and, for encdec, ``frames`` (B,S_enc,D)
(the audio frontend's stub), or for vlm optionally ``patches`` (B,P,D)
(the vision frontend's stub), which are projected and put before the text
tokens. Frames and patches are cast to the model dtype first; the
reference promotes fp32 patches' whole stream, ring included, to fp32 and
raises on fp32 frames in a bf16 model.

``forward(..., is_train=True)`` (what ``loss_fn`` runs) is the training
route: every norm, attention and WKV call takes its differentiable torch
ops, the counterpart of JAX's XLA path, each decoder layer is
rematerialised under ``cfg.remat`` "block" or "dots" (the encoder's are
not, as in the reference), and each MoE layer adds its load-balancing
loss to the auxiliary loss. The serving steps pass ``is_train=False`` and reach the
kernels.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import effective_cache_len
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba, mlp_moe, rwkv
from repro_torch.models.common import grad_cast, init_param, rms_norm


def init_model(cfg: ModelConfig, generator: torch.Generator,
               device=None) -> Dict:
    """Random weights from ``generator``, on ``device`` (cuda by default)."""
    dev = resolve_device(device)
    D, dt = cfg.d_model, cfg.torch_dtype
    p: Dict = {
        "embed": init_param((cfg.padded_vocab, D), generator, dt, dev),
        "final_norm": torch.ones((D,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = init_param((D, cfg.padded_vocab), generator, dt, dev)
    layers = []
    for is_moe in cfg.moe_layer_mask():
        lp = {"norm1": torch.ones((D,), dtype=dt, device=dev),
              "norm2": torch.ones((D,), dtype=dt, device=dev)}
        if cfg.family == "ssm":
            lp["tm"] = rwkv.init_time_mix(cfg, generator, dev)
            lp["cm"] = rwkv.init_channel_mix(cfg, generator, dev)
        else:
            lp["attn"] = (attn_mod.init_mla(cfg, generator, dev) if cfg.is_mla
                          else attn_mod.init_attention(cfg, generator, dev))
            if cfg.family == "hybrid":
                lp["ssm"] = mamba.init_mamba(cfg, generator, dev)
            if is_moe:
                lp["moe"] = mlp_moe.init_moe(cfg, generator, dev)
            else:
                lp["mlp"] = mlp_moe.init_mlp(cfg, generator, dev)
        if cfg.is_encdec:
            lp["cross"] = attn_mod.init_attention(cfg, generator, dev,
                                                  cross=True)
            lp["norm3"] = torch.ones((D,), dtype=dt, device=dev)
        layers.append(lp)
    p["layers"] = layers
    if cfg.is_encdec:
        p["enc"] = {"layers": [
            {"attn": attn_mod.init_attention(cfg, generator, dev),
             "mlp": mlp_moe.init_mlp(cfg, generator, dev),
             "norm1": torch.ones((D,), dtype=dt, device=dev),
             "norm2": torch.ones((D,), dtype=dt, device=dev)}
            for _ in range(cfg.n_encoder_layers)],
            "final_norm": torch.ones((D,), dtype=dt, device=dev)}
    if cfg.frontend == "audio_frames":
        p["frame_proj"] = init_param((D, D), generator, dt, dev)
    if cfg.frontend == "vision_patches":
        p["patch_proj"] = init_param((D, D), generator, dt, dev)
    return p


def _n_patches(cfg: ModelConfig, batch: Dict) -> int:
    """The image patches put before the text tokens (0 without any)."""
    if cfg.frontend == "vision_patches" and "patches" in batch:
        return batch["patches"].shape[1]
    return 0


def _embed_tokens(cfg: ModelConfig, p: Dict, batch: Dict) -> torch.Tensor:
    x = p["embed"][batch["tokens"].long()]
    if _n_patches(cfg, batch):
        vis = batch["patches"].to(x.dtype) @ p["patch_proj"]
        x = torch.cat([vis, x], dim=1)
    return x


def _encoder(cfg: ModelConfig, p: Dict, frames: torch.Tensor, *,
             is_train: bool) -> torch.Tensor:
    """The encoder over the projected frames: unmasked, roped
    self-attention and the FFN in every layer, then its final norm."""
    enc = p["enc"]
    x = frames.to(p["frame_proj"].dtype) @ p["frame_proj"]
    for lp in enc["layers"]:
        a_in = rms_norm(x, lp["norm1"], cfg.norm_eps, is_train=is_train)
        x = x + attn_mod.attend(lp["attn"], cfg, a_in, causal=False,
                                is_train=is_train)
        f_in = rms_norm(x, lp["norm2"], cfg.norm_eps, is_train=is_train)
        x = x + mlp_moe.mlp(lp["mlp"], cfg, f_in)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps, is_train=is_train)


def _unembed(cfg: ModelConfig, p: Dict, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits (the JAX einsum's preferred_element_type=f32), with the
    padded vocab entries set to -1e30.

    On the card a bf16 GEMM writes fp32 directly, so the (D, V) weight is
    read once as it is; the CPU has no such GEMM and upcasts both sides."""
    w = p["embed"].t() if cfg.tie_embeddings else p["unembed"]
    if h.is_cuda and h.dtype == torch.bfloat16:
        logits = torch.mm(h.reshape(-1, h.shape[-1]), w,
                          out_dtype=torch.float32).view(*h.shape[:-1], -1)
    else:
        logits = h.float() @ w.float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _rwkv_layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor, *,
                is_train: bool):
    """One rwkv6 layer over a whole sequence from a zero state and zero
    token shifts. Returns (x, no aux loss, {"ssm_state", "shift_tm",
    "shift_cm"})."""
    shift0 = torch.zeros((x.shape[0], cfg.d_model), dtype=x.dtype,
                         device=x.device)
    a_in = rms_norm(x, lp["norm1"], cfg.norm_eps, is_train=is_train)
    tm_out, tm_shift, s_f = rwkv.time_mix(lp["tm"], cfg, a_in, shift0, None,
                                          is_train=is_train)
    x = x + tm_out
    c_in = rms_norm(x, lp["norm2"], cfg.norm_eps, is_train=is_train)
    cm_out, cm_shift = rwkv.channel_mix(lp["cm"], cfg, c_in, shift0)
    return x + cm_out, None, {"ssm_state": s_f, "shift_tm": tm_shift,
                              "shift_cm": cm_shift}


def _ffn(cfg: ModelConfig, lp: Dict, x: torch.Tensor, is_train: bool):
    """A layer's FFN: (out, its load-balancing loss on the training route
    of a MoE layer, else None)."""
    if "moe" in lp:
        aux = mlp_moe.moe_aux_loss(lp["moe"], cfg, x) if is_train else None
        return mlp_moe.moe(lp["moe"], cfg, x), aux
    return mlp_moe.mlp(lp["mlp"], cfg, x), None


def _attn_layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                memory: Optional[torch.Tensor] = None, *, is_train: bool,
                collect_cache: bool, cache_len: int):
    """One layer of an attention family over a whole sequence: attention
    (with the hybrid family's SSM heads beside it on the same normed input,
    their outputs summed), for encdec then cross-attention on the encoder's
    output ``memory``, then the dense or MoE FFN. Returns (x, the layer's
    aux loss or None, its cache leaves, empty without ``collect_cache``;
    encdec adds the cross K/V ``cross_k``/``cross_v`` (B,S_enc,KV*hd))."""
    a_in = rms_norm(x, lp["norm1"], cfg.norm_eps, is_train=is_train)
    y = {}
    if cfg.is_mla:
        a_out = attn_mod.mla_attend(lp["attn"], cfg, a_in, is_train=is_train,
                                    return_latent=collect_cache)
        if collect_cache:
            a_out, lat = a_out
            y = {"latent": attn_mod.pack_ring(lat, cache_len)}
    elif collect_cache:
        a_out, (kk, vv) = attn_mod.attend(lp["attn"], cfg, a_in,
                                          return_kv=True, is_train=is_train)
        y = {"k": attn_mod.pack_ring(kk, cache_len),
             "v": attn_mod.pack_ring(vv, cache_len)}
        if cfg.kv_quant:
            y["k"], y["k_scale"] = attn_mod.quantize_kv(y["k"], cfg.n_kv_heads)
            y["v"], y["v_scale"] = attn_mod.quantize_kv(y["v"], cfg.n_kv_heads)
    else:
        a_out = attn_mod.attend(lp["attn"], cfg, a_in, is_train=is_train)
    if "ssm" in lp:
        s0 = torch.zeros((x.shape[0], cfg.n_ssm_heads, cfg.ssm.head_dim,
                          cfg.ssm.state_size), dtype=torch.float32,
                         device=x.device)
        m_out, s_f, conv = mamba.mamba_mix(lp["ssm"], cfg, a_in, s0)
        a_out = a_out + m_out
        if collect_cache:
            y["ssm_state"] = s_f
            if conv is not None:
                y["conv_state"] = conv
    x = x + a_out
    if "cross" in lp:
        c_in = rms_norm(x, lp["norm3"], cfg.norm_eps, is_train=is_train)
        c_out = attn_mod.attend(lp["cross"], cfg, c_in, causal=False,
                                kv_x=memory, use_rope=False,
                                return_kv=collect_cache, is_train=is_train)
        if collect_cache:
            c_out, (y["cross_k"], y["cross_v"]) = c_out
        x = x + c_out
    f_in = rms_norm(x, lp["norm2"], cfg.norm_eps, is_train=is_train)
    f_out, aux = _ffn(cfg, lp, f_in, is_train)
    return x + f_out, aux, y


# the products with no batch dimension: every projection (a 2- or 3-D
# activation times a 2-D weight folds to mm) and the MoE router. The
# batched products (bmm: attention's scores and P.V, the experts, the MoE
# dispatch and combine, the SSM heads' readout) have a batch dimension in
# the reference's einsums too, even where it is 1 (one MoE group).
_NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of the
    products with no batch dimension, recompute everything else."""
    if op in _NO_BATCH_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(layer, cfg: ModelConfig):
    """Layer rematerialisation (``repro.models.model._remat``): "block"
    keeps only each layer's input for the backward and recomputes the rest;
    "dots" also keeps the outputs of the products with no batch dimension
    (``_dots_policy``), so the backward recomputes no projection (more live
    memory, less recompute). A layer draws no random numbers, so no RNG
    state is stashed."""
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, layer, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def _stack(cfg: ModelConfig, params: Dict, batch: Dict, *, is_train: bool,
           collect_cache: bool, cache_len: int):
    """(final hidden states, aux loss (fp32 scalar), cache or None): JAX's
    ``forward``."""
    memory = (_encoder(cfg, params, batch["frames"], is_train=is_train)
              if cfg.is_encdec else None)
    x = _embed_tokens(cfg, params, batch)
    if cfg.family == "ssm":
        layer = functools.partial(_rwkv_layer, cfg, is_train=is_train)
    else:
        layer = functools.partial(_attn_layer, cfg, is_train=is_train,
                                  collect_cache=collect_cache,
                                  cache_len=cache_len)
    if is_train and cfg.remat != "none":
        layer = _remat(layer, cfg)
    leaves = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, a, y = layer(lp, x) if memory is None else layer(lp, x, memory)
        if a is not None:
            aux = aux + a
        for k, t in y.items():
            leaves.setdefault(k, []).append(t)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps, is_train=is_train)
    cache = ({k: torch.stack(ts) for k, ts in leaves.items()}
             if collect_cache else None)
    return h, aux, cache


def forward(cfg: ModelConfig, params: Dict, batch: Dict, *,
            is_train: bool = True, collect_cache: bool = False,
            cache_len: int = 0):
    """Final hidden states (B,S,D) (S counts the patches before the text
    for vlm; the decoder's tokens only for encdec) and, with
    ``collect_cache``, the
    layer-stacked cache: the ring buffers {"k", "v"} of
    (L,B,cache_len,KV*hd) for the attention families (with ``cfg.kv_quant``
    int8 codes and {"k_scale", "v_scale"} (L,B,cache_len,KV); attention
    itself runs on the unquantized K/V, as in JAX), for hybrid also the SSM
    state {"ssm_state" (L,B,H,hd,N) fp32, "conv_state" (L,B,cw-1,H*hd)};
    the recurrent state {"ssm_state" (L,B,H,hd,hd) fp32, "shift_tm",
    "shift_cm" (L,B,D)} for ssm; encdec adds the cross K/V {"cross_k",
    "cross_v"} (L,B,S_enc,KV*hd). As in JAX, ``is_train`` is the default:
    the training route (module docstring); the serving steps pass
    ``is_train=False``. ``loss_fn`` also takes the MoE aux loss."""
    h, _, cache = _stack(cfg, params, batch, is_train=is_train,
                         collect_cache=collect_cache, cache_len=cache_len)
    return h, cache


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy)
# ---------------------------------------------------------------------------

def chunked_xent(cfg: ModelConfig, params: Dict, h: torch.Tensor,
                 targets: torch.Tensor, chunk: int = 512):
    """Mean token cross-entropy and accuracy of h (B,S,D) against targets
    (B,S), over 512-token chunks of the sequence when S divides by 512,
    else one chunk. Each chunk's logits are fp32 (the JAX einsum's
    preferred_element_type), the padded vocab at -1e30."""
    B, S, D = h.shape
    w = (params["embed"].t() if cfg.tie_embeddings else params["unembed"]).float()
    c = chunk if S % chunk == 0 else S
    pad_mask = (torch.arange(cfg.padded_vocab, device=h.device)
                >= cfg.vocab_size) * -1e30
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    correct = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, S, c):
        tt = targets[:, i:i + c].long()
        logits = h[:, i:i + c].float() @ w + pad_mask
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tt[..., None])[..., 0]
        loss = loss + torch.sum(lse - gold)
        correct = correct + torch.sum(torch.argmax(logits, -1) == tt)
    ntok = B * S
    return loss / ntok, correct.float() / ntok


def loss_fn(cfg: ModelConfig, params: Dict, batch: Dict,
            aux_weight: float = 0.01):
    """(total, {"loss", "aux_loss", "accuracy"}) on the training route;
    total = loss + aux_weight * aux, where aux sums the MoE layers'
    load-balancing losses (0 for the other families). The patch positions
    of a vlm batch carry no target and are dropped first."""
    h, aux, _ = _stack(cfg, params, batch, is_train=True, collect_cache=False,
                       cache_len=0)
    h = h[:, _n_patches(cfg, batch):]
    # keep the backward residual stream in the model dtype
    loss, acc = chunked_xent(cfg, params, grad_cast(h, cfg.torch_dtype),
                             batch["targets"])
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux_loss": aux, "accuracy": acc}


def prefill_step(cfg: ModelConfig, params: Dict, batch: Dict,
                 max_len: Optional[int] = None,
                 true_lens: Optional[torch.Tensor] = None):
    """Run the prompt, return (cache, last-token logits (B,1,V) fp32).

    The ring holds ``max_len`` slots (bounded by a window or chunk), or
    without ``max_len`` the prompt's length, counting the frames (encdec)
    or the patches (vlm) too, as the reference counts them. ``pos`` counts
    the decoder's tokens: for encdec the text tokens only, for vlm the
    patches and the text.

    ``true_lens`` (B,) supports right-padded prompts: logits are taken at
    each row's true last token (after the patches for vlm) and decoding
    starts there; the padded ring slots are masked at decode because their
    slot position exceeds pos, as long as the padded length fits the ring
    (the engine prefills longer buckets at their exact length). The
    recurrent (ssm, hybrid) state has no such mask: its prompts must not be
    padded. A MoE layer routes pad tokens too, and they take expert
    capacity, as in JAX.

    One deviation from the reference, a repair: with patches and
    ``true_lens``, ``pos`` is true_lens + the patch count. The reference
    sets it to true_lens (``repro/models/model.py:368``), so its next decode
    step would rope the token at the text's length and write it over a
    patch's ring slot. No reference caller passes both."""
    T = batch["tokens"].shape[1]
    n_front = _n_patches(cfg, batch)
    S = T + (batch["frames"].shape[1] if cfg.is_encdec else n_front)
    C = effective_cache_len(cfg, max_len or S)
    h, cache = forward(cfg, params, batch, is_train=False, collect_cache=True,
                       cache_len=C)
    B, dev = h.shape[0], h.device
    if true_lens is None:
        pos = torch.full((B,), h.shape[1], dtype=torch.int32, device=dev)
        logits = _unembed(cfg, params, h[:, -1:, :])
    else:
        true_lens = true_lens.to(dev)
        pos = (true_lens + n_front).to(torch.int32)
        idx = torch.clamp(true_lens.long() - 1 + n_front, 0, h.shape[1] - 1)
        logits = _unembed(cfg, params,
                          h[torch.arange(B, device=dev), idx][:, None, :])
    cache["pos"] = pos
    return cache, logits


def _rwkv_decode(cfg: ModelConfig, params: Dict, x: torch.Tensor,
                 cache: Dict) -> torch.Tensor:
    """The rwkv6 layers for one token; the cache's ``ssm_state``,
    ``shift_tm`` and ``shift_cm`` are updated in place."""
    for l, lp in enumerate(params["layers"]):
        a_in = rms_norm(x, lp["norm1"], cfg.norm_eps)
        tm_out, tm_shift, _ = rwkv.time_mix_step(
            lp["tm"], cfg, a_in, cache["shift_tm"][l], cache["ssm_state"][l])
        cache["shift_tm"][l].copy_(tm_shift)
        x = x + tm_out
        c_in = rms_norm(x, lp["norm2"], cfg.norm_eps)
        cm_out, cm_shift = rwkv.channel_mix(lp["cm"], cfg, c_in,
                                            cache["shift_cm"][l])
        cache["shift_cm"][l].copy_(cm_shift)
        x = x + cm_out
    return x


def decode_step(cfg: ModelConfig, params: Dict, tokens: torch.Tensor,
                cache: Dict):
    """One decode step for the whole batch. tokens: (B,1).

    The cache's buffers (K/V and, with kv_quant, their scales; the hybrid
    family's SSM and conv states; or the recurrent state and token shifts)
    are updated IN PLACE (the JAX version returns a new cache); encdec's
    cross K/V are only read. ``pos`` is advanced in place too, so every
    tensor of the cache stays the object it was (a captured step reads and
    writes the same buffers at every replay). Returns (logits, cache)."""
    x = params["embed"][tokens.long()]
    pos = cache["pos"]
    if cfg.family == "ssm":
        x = _rwkv_decode(cfg, params, x, cache)
    else:
        if cfg.is_encdec:     # the last of the encoder's slots
            enc_pos = torch.full_like(pos, cache["cross_k"].shape[2] - 1)
        for l, lp in enumerate(params["layers"]):
            a_in = rms_norm(x, lp["norm1"], cfg.norm_eps)
            if cfg.is_mla:
                a_out = attn_mod.mla_decode_attend(lp["attn"], cfg, a_in, pos,
                                                   cache["latent"][l])
            else:
                scales = ((cache["k_scale"][l], cache["v_scale"][l])
                          if cfg.kv_quant else ())
                a_out = attn_mod.decode_attend(lp["attn"], cfg, a_in, pos,
                                               cache["k"][l], cache["v"][l],
                                               *scales)[0]
            if "ssm" in lp:
                conv = cache["conv_state"][l] if "conv_state" in cache else None
                m_out, s2, c2 = mamba.mamba_step(lp["ssm"], cfg, a_in,
                                                 cache["ssm_state"][l], conv)
                cache["ssm_state"][l].copy_(s2)
                if conv is not None:
                    conv.copy_(c2)
                a_out = a_out + m_out
            x = x + a_out
            if "cross" in lp:
                c_in = rms_norm(x, lp["norm3"], cfg.norm_eps)
                x = x + attn_mod.cross_decode_attend(
                    lp["cross"], cfg, c_in, cache["cross_k"][l],
                    cache["cross_v"][l], enc_pos)
            f_in = rms_norm(x, lp["norm2"], cfg.norm_eps)
            x = x + _ffn(cfg, lp, f_in, is_train=False)[0]
    pos.add_(1)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(cfg, params, h), cache
