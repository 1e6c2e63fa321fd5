"""Plain float32 reference of a served request on DeepSeek-V2 (Lite).

Written from the published architecture (the Hugging Face
``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite and arXiv:2405.04434)
and from what the serving engine states it does, in plain PyTorch and
nothing else: it imports no kernel, no JAX and nothing of the program. It
reads the benchmark's weights (the tensors the program was handed) and
works one layer at a time, and one expert at a time, in float32 with TF32
off.

The architecture, restated:
- pre-norm RMSNorm blocks, an untied output head;
- latent attention (MLA) with no q compression, in its published
  decompressed form at every position: q = x wq, per head [q_nope (128) |
  q_rope (64)]; [c (512) | k_rope (64)] = x wkv_a, c RMS-normed by its own
  gain; per head [k_nope (128) | v (128)] = c wkv_b; K = [k_nope | k_rope]
  with the one k_rope shared by all heads; q_rope and k_rope rotated (rotate
  half) at YaRN's frequencies (NTK-by-parts between theta's and theta's over
  ``factor``, cos and sin unscaled since mscale = mscale_all_dim); causal
  softmax attention at scale (nope + rope) ** -0.5 x mscale(mscale_all_dim)
  ** 2; the heads' outputs through wo. Absorbing W_UK and W_UV into the
  decode step is the program's choice, not restated here;
- the first ``first_k_dense_replace`` layers have a dense SwiGLU FFN; every
  other layer routes each token by a softmax over all routed experts'
  logits, takes the greedy top-k of those weights (the lower expert first
  among equals), does not renormalise them (``norm_topk_prob`` false,
  ``routed_scaling_factor`` 1) and adds the shared experts (one SwiGLU of
  n_shared x the expert width) for every token.

What the engine states, and the reference restates here:
- a prompt is the byte tokenizer's ids (BOS 256, then the UTF-8 bytes), of
  which the last ``max_len // 2`` are kept;
- it is prefilled as one row, right-padded with id 0 to a power-of-two
  bucket (at least 8, at most ``max_len``); pad tokens sit after the
  prompt, so causal attention never lets a true token see them, but the
  expert layers route them and they take capacity;
- at a prefill each expert is capped at a capacity per group of tokens: a
  prompt's tokens form groups of 1,024 when their count divides by 1,024,
  else one group; capacity is group x k x 1.25 / experts (floored, at
  least k), or group x k where that is at most 64; places are handed out
  first choices first, then second and so on, in token order, and a
  (token, choice) past capacity adds nothing;
- a decode step is never capped: every generated token reaches all of its
  k experts.

``served_logits`` returns float32 logits at every position that produced a
served token: the prompt's last, then each served token but the last.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

BOS = 256
CAPACITY_FACTOR = 1.25
GROUP_TOKENS = 1024
NEVER_CAPPED = 64

Linear = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def plain_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.float()


def tokenize(prompt: str, max_len: int) -> List[int]:
    return ([BOS] + list(prompt.encode("utf-8", errors="replace")))[-(max_len // 2):]


def prefill_len(n: int, max_len: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, max_len)


def capacity(group: int, top_k: int, n_experts: int) -> int:
    if group * top_k <= NEVER_CAPPED:
        return group * top_k
    return max(int(group * top_k * CAPACITY_FACTOR / n_experts), top_k)


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, y: Dict) -> torch.Tensor:
    """YaRN's dim/2 inverse frequencies (float64): theta's below the low
    correction dim, theta's over ``factor`` above the high one, a linear
    ramp between; the correction dim of r rotations over the original
    context L0 is dim ln(L0 / (2 pi r)) / (2 ln theta)."""
    def corr(rot):
        return dim * math.log(y["original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    extra = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float64) - low)
                       / (high - low), 0, 1)
    return extra / y["factor"] * ramp + extra * (1 - ramp)


def _rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """x (S, H, d); rotate-half rotary embedding at positions pos (S,)."""
    half = x.shape[-1] // 2
    ang = pos.double()[:, None] * inv.to(x.device)[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q_pos, k_pos, scale: float, rows: int = 512):
    """Causal softmax attention. q, k (S, H, dk); v (Sk, H, dv)."""
    out = q.new_empty((q.shape[0], q.shape[1], v.shape[-1]))
    for a in range(0, q.shape[0], rows):
        ok = k_pos[None, :] <= q_pos[a:a + rows, None]
        s = torch.einsum("chd,thd->hct", q[a:a + rows], k) * scale
        s = s.masked_fill(~ok[None], float("-inf"))
        out[a:a + rows] = torch.einsum("hct,thd->chd", torch.softmax(s, dim=-1), v)
    return out


def _mla(streams, a, sizes, linear: Linear):
    """Latent attention of the prefill and decode streams; each stream is
    (h, positions), the decode stream's keys being the prompt's true
    tokens and the decode tokens before it."""
    H, r = sizes["n_heads"], sizes["kv_rank"]
    nope, rope, vd = sizes["nope"], sizes["rope"], sizes["v_dim"]
    y = sizes["yarn"]
    inv = yarn_inv_freq(rope, sizes["rope_theta"], y)
    scale = (nope + rope) ** -0.5 * _mscale(y["factor"], y["mscale_all_dim"]) ** 2
    wq, wkv_a, wkv_b, wo = (a[k].float() for k in ("wq", "wkv_a", "wkv_b", "wo"))
    qkv = []
    for h, pos in streams:
        S = h.shape[0]
        q = linear(h, wq).view(S, H, nope + rope)
        kv_a = linear(h, wkv_a)
        c = _rms(kv_a[:, :r], a["kv_norm"], sizes["norm_eps"])
        k_rope = _rope(kv_a[:, None, r:], pos, inv).expand(S, H, rope)
        kv = linear(c, wkv_b).view(S, H, nope + vd)
        qkv.append((torch.cat([q[..., :nope], _rope(q[..., nope:], pos, inv)], -1),
                    torch.cat([kv[..., :nope], k_rope], -1), kv[..., nope:]))
    (qp, kp, vp), (qd, kd, vd_) = qkv
    (_, pre_pos), (_, dec_pos) = streams
    n = sizes["_n"]
    op = _attend(qp, kp, vp, pre_pos, pre_pos, scale)
    od = _attend(qd, torch.cat([kp[:n], kd]), torch.cat([vp[:n], vd_]), dec_pos,
                 torch.cat([pre_pos[:n], dec_pos]), scale)
    return [linear(o.reshape(o.shape[0], -1), wo) for o in (op, od)]


def _route(x, router, sizes, capped: bool, linear: Linear):
    """(chosen experts (T, K), weights (T, K), kept (T, K)) of tokens x."""
    E, K = sizes["n_experts"], sizes["top_k"]
    probs = torch.softmax(linear(x, router), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    gates = torch.gather(probs, 1, idx)
    kept = torch.ones_like(idx, dtype=torch.bool)
    if capped:
        T = x.shape[0]
        g = GROUP_TOKENS if T % GROUP_TOKENS == 0 else T
        cap = capacity(g, K, E)
        for a in range(0, T, g):
            oh = torch.nn.functional.one_hot(idx[a:a + g], E)      # (g, K, E)
            flat = oh.transpose(0, 1).reshape(K * g, E)             # k-major
            place = (torch.cumsum(flat, 0) - 1) * flat
            place = place.reshape(K, g, E).transpose(0, 1).sum(-1)  # (g, K)
            kept[a:a + g] = place < cap
    return idx, gates, kept


def _swiglu(x, wg, wu, wd, linear: Linear):
    return linear(torch.nn.functional.silu(linear(x, wg)) * linear(x, wu), wd)


def _ffn(streams, lp, sizes, linear: Linear):
    """streams: [(x, capped)] -> the FFN output of each."""
    if "mlp" in lp:
        p = lp["mlp"]
        return [_swiglu(x, p["w_gate"].float(), p["w_up"].float(), p["w_down"].float(),
                        linear) for x, _ in streams]
    m = lp["moe"]
    routed = [(x, *_route(x, m["router"].float(), sizes, capped, linear))
              for x, capped in streams]
    outs = [_swiglu(x, m["ws_gate"].float(), m["ws_up"].float(), m["ws_down"].float(),
                    linear) for x, _ in streams]
    for e in range(sizes["n_experts"]):
        wg, wu, wd = (m[k][e].float() for k in ("we_gate", "we_up", "we_down"))
        for (x, idx, gates, kept), out in zip(routed, outs):
            t, j = torch.nonzero((idx == e) & kept, as_tuple=True)
            if t.numel():
                out.index_add_(0, t, _swiglu(x[t], wg, wu, wd, linear) * gates[t, j, None])
        del wg, wu, wd
    return outs


@torch.no_grad()
def served_logits(sizes: Dict, params: Dict, prompt_ids: List[int],
                  served: List[int], *, max_len: int,
                  linear: Linear = plain_linear) -> torch.Tensor:
    """(len(served), vocab) float32 logits at the positions that produced
    each served token. ``linear(x, w)`` computes every weight product (the
    control passes a lower-precision one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = params["embed"].device
    n, eps = len(prompt_ids), sizes["norm_eps"]
    s_pre = prefill_len(n, max_len)
    if s_pre % GROUP_TOKENS == 0:
        # groups after the one holding the last true token touch nothing
        # the served tokens depend on
        s_pre = min(s_pre, -(-n // GROUP_TOKENS) * GROUP_TOKENS)
    sizes = dict(sizes, _n=n)
    pre_ids = torch.tensor(prompt_ids + [0] * (s_pre - n), device=dev)
    dec_ids = torch.tensor(served[:-1], dtype=torch.long, device=dev)
    pre_pos = torch.arange(s_pre, device=dev)
    dec_pos = torch.arange(n, n + dec_ids.numel(), device=dev)
    embed = params["embed"]
    xp, xd = embed[pre_ids].float(), embed[dec_ids].float()
    for lp in params["layers"]:
        ap, ad = _mla([(_rms(xp, lp["norm1"], eps), pre_pos),
                       (_rms(xd, lp["norm1"], eps), dec_pos)], lp["attn"], sizes, linear)
        xp, xd = xp + ap, xd + ad
        del ap, ad
        fp, fd = _ffn([(_rms(xp, lp["norm2"], eps), True),
                       (_rms(xd, lp["norm2"], eps), False)], lp, sizes, linear)
        xp, xd = xp + fp, xd + fd
    h = torch.cat([xp[n - 1:n], xd])
    h = _rms(h, params["final_norm"], eps)
    w = params["embed"].t() if sizes["tie_embeddings"] else params["unembed"]
    return linear(h, w)[:, :sizes["vocab_size"]]
