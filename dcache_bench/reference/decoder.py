"""Plain float32 reference of a served request on a dense or MoE decoder.

Written from the published architecture (pre-norm RMSNorm blocks, rotary
attention with grouped K/V heads, a SwiGLU FFN or top-k routed SwiGLU
experts, tied or untied output head) and from what the serving engine
states it does, in plain PyTorch and nothing else: it imports no kernel,
no JAX and nothing of the program. It reads the benchmark's weights (the
tensors the program was handed) and works out all it needs from them one
layer at a time, and one expert at a time, in float32 with TF32 off.

What the engine states, and the reference restates here:
- a prompt is the byte tokenizer's ids (BOS 256, then the UTF-8 bytes),
  of which the last ``max_len // 2`` are kept;
- it is prefilled as one row, right-padded with id 0 to a power-of-two
  bucket (at least 8, at most ``max_len``) unless that bucket is longer
  than the ring; pad tokens sit after the prompt, so causal attention
  never lets a true token see them, but an expert layer routes them and
  they take capacity;
- an expert layer routes each token to its top-k experts (stable order:
  the lower expert first among equal logits), weights them by the softmax
  of the chosen logits, and caps each expert at a capacity per group of
  tokens: a prompt's tokens form groups of 1,024 when their count divides
  by 1,024, else one group; capacity is group x k x 1.25 / experts
  (floored, at least k), or group x k where that is at most 64; places
  are handed out first choices first, then second, in token order, and a
  (token, choice) past capacity adds nothing;
- each generated token is decoded in a batch of ``max_batch`` rows whose
  group of ``max_batch`` x k choices is within the 64 that are never
  capped, so it reaches all of its experts.

``served_logits`` returns float32 logits at every position that produced a
served token: the prompt's last, then each served token but the last.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

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


def prefill_len(n: int, max_len: int, ring: int) -> int:
    b = 8
    while b < n:
        b *= 2
    b = min(b, max_len)
    return n if b > ring else b


def capacity(group: int, top_k: int, n_experts: int) -> int:
    if group * top_k <= NEVER_CAPPED:
        return group * top_k
    return max(int(group * top_k * CAPACITY_FACTOR / n_experts), top_k)


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd); rotate-half rotary embedding at positions pos (S,)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q_pos, k_pos, window: Optional[int], rows: int = 512):
    """Causal softmax attention. q (Sq, Hq, hd); k, v (Sk, KV, hd)."""
    Sq, Hq, hd = q.shape
    KV = k.shape[1]
    G = Hq // KV
    out = torch.empty_like(q)
    for a in range(0, Sq, rows):
        qp = q_pos[a:a + rows, None]
        ok = k_pos[None, :] <= qp
        if window:
            ok &= (qp - k_pos[None, :]) < window
        for h in range(KV):
            s = torch.einsum("cgd,td->gct", q[a:a + rows, h * G:(h + 1) * G],
                             k[:, h]) / math.sqrt(hd)
            s = s.masked_fill(~ok[None], float("-inf"))
            out[a:a + rows, h * G:(h + 1) * G] = torch.einsum(
                "gct,td->cgd", torch.softmax(s, dim=-1), v[:, h])
    return out


def _route(x, router, sizes, capped: bool, linear: Linear):
    """(chosen experts (T, K), gates (T, K), kept (T, K)) of tokens x."""
    E, K = sizes["n_experts"], sizes["top_k"]
    logits = linear(x, router)
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :K]
    gates = torch.softmax(torch.gather(logits, 1, idx), dim=-1)
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


def _experts(streams, lp, sizes, linear: Linear):
    """SwiGLU experts for each (x, idx, gates, kept) stream, one expert's
    float32 weights at a time."""
    outs = [torch.zeros_like(x) for x, *_ in streams]
    for e in range(sizes["n_experts"]):
        wg, wu, wd = (lp[k][e].float() for k in ("we_gate", "we_up", "we_down"))
        for (x, idx, gates, kept), out in zip(streams, outs):
            t, j = torch.nonzero((idx == e) & kept, as_tuple=True)
            if t.numel() == 0:
                continue
            h = x[t]
            y = linear(torch.nn.functional.silu(linear(h, wg)) * linear(h, wu), wd)
            out.index_add_(0, t, y * gates[t, j, None])
        del wg, wu, wd
    return outs


def _ffn(streams, lp, sizes, linear: Linear):
    """streams: [(x, capped)] -> the FFN output of each."""
    if "moe" in lp:
        m = lp["moe"]
        routed = [(x, *_route(x, m["router"], sizes, capped, linear))
                  for x, capped in streams]
        return _experts(routed, m, sizes, linear)
    p = lp["mlp"]
    wg, wu, wd = p["w_gate"].float(), p["w_up"].float(), p["w_down"].float()
    return [linear(torch.nn.functional.silu(linear(x, wg)) * linear(x, wu), wd)
            for x, _ in streams]


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
    n, eps, theta = len(prompt_ids), sizes["norm_eps"], sizes["rope_theta"]
    window, hd = sizes.get("sliding_window"), sizes["head_dim"]
    moe = bool(sizes.get("n_experts"))
    if moe and sizes["max_batch"] * sizes["top_k"] > NEVER_CAPPED:
        raise ValueError("decode batches beyond the uncapped group size are "
                         "not covered by this reference")
    s_pre = prefill_len(n, max_len, sizes["ring"]) if moe else n
    if s_pre % GROUP_TOKENS == 0:
        # groups after the one holding the last true token touch nothing
        # the served tokens depend on
        s_pre = min(s_pre, -(-n // GROUP_TOKENS) * GROUP_TOKENS)
    pre_ids = torch.tensor(prompt_ids + [0] * (s_pre - n), device=dev)
    dec_ids = torch.tensor(served[:-1], dtype=torch.long, device=dev)
    pre_pos = torch.arange(s_pre, device=dev)
    dec_pos = torch.arange(n, n + dec_ids.numel(), device=dev)
    embed = params["embed"]
    xp, xd = embed[pre_ids].float(), embed[dec_ids].float()
    for lp in params["layers"]:
        a = lp["attn"]
        wq, wk, wv, wo = (a[k].float() for k in ("wq", "wk", "wv", "wo"))
        hp, hdn = _rms(xp, lp["norm1"], eps), _rms(xd, lp["norm1"], eps)
        qkv = []
        for h, pos in ((hp, pre_pos), (hdn, dec_pos)):
            q = _rope(linear(h, wq).view(h.shape[0], -1, hd), pos, theta)
            k = _rope(linear(h, wk).view(h.shape[0], -1, hd), pos, theta)
            qkv.append((q, k, linear(h, wv).view(h.shape[0], -1, hd)))
        (qp, kp, vp), (qd, kd, vd) = qkv
        op = _attend(qp, kp, vp, pre_pos, pre_pos, window)
        kk, vv = torch.cat([kp[:n], kd]), torch.cat([vp[:n], vd])
        od = _attend(qd, kk, vv, dec_pos, torch.cat([pre_pos[:n], dec_pos]), window)
        xp = xp + linear(op.reshape(s_pre, -1), wo)
        xd = xd + linear(od.reshape(xd.shape[0], -1), wo)
        del wq, wk, wv, wo, qkv, qp, kp, vp, qd, kd, vd, kk, vv, op, od
        fp, fd = _ffn([(_rms(xp, lp["norm2"], eps), True),
                       (_rms(xd, lp["norm2"], eps), False)], lp, sizes, linear)
        xp, xd = xp + fp, xd + fd
    h = torch.cat([xp[n - 1:n], xd])
    h = _rms(h, params["final_norm"], eps)
    w = params["embed"].t() if sizes["tie_embeddings"] else params["unembed"]
    return linear(h, w)[:, :sizes["vocab_size"]]
