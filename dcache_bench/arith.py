"""Operations and bytes of the served work, counted from shapes.

A frozen yardstick in the manner of ``repro_torch/launch/dryrun.py``'s
``model_flops`` and ``analytic_hbm_bytes``, but counted from the sizes of
the benchmark's own configuration file rather than from
``ModelConfig.param_count``. Work that depends on the data counts what the
inputs need: a prompt's true length (not its padded bucket), a decode
row's valid ring positions (not the whole ring), the active experts of a
token (not all of them).

Peaks: one H100 SXM, NVIDIA's data sheet, dense bf16 989 TFLOP/s, HBM3
3.35 TB/s, at the full 700 W power limit.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12
BF16_BYTES = 2


def weight_params(sizes: Dict) -> int:
    """Parameters of the decoder (embedding and head, all experts)."""
    D, F, L = sizes["d_model"], sizes["d_ff"], sizes["n_layers"]
    V = -(-sizes["vocab_size"] // 256) * 256
    layer = _attn_params(sizes) + 2 * D
    E = sizes.get("n_experts", 0)
    layer += (E * 3 * D * F + D * E) if E else 3 * D * F
    head = V * D * (1 if sizes["tie_embeddings"] else 2)
    return L * layer + head + D


def _attn_params(sizes: Dict) -> int:
    D, hd = sizes["d_model"], sizes["head_dim"]
    q, kv = sizes["n_heads"] * hd, sizes["n_kv_heads"] * hd
    return 2 * D * q + 2 * D * kv


def ring_bytes(sizes: Dict, max_batch: int, max_len: int) -> int:
    C = min(max_len, sizes.get("sliding_window") or max_len)
    return (sizes["n_layers"] * max_batch * C * 2 * sizes["n_kv_heads"]
            * sizes["head_dim"] * BF16_BYTES)


def matmul_flops_per_token(sizes: Dict) -> int:
    """2 x the weights a token multiplies in the layers: attention's
    projections, the router and its top-k experts (or the dense FFN)."""
    D, F, L = sizes["d_model"], sizes["d_ff"], sizes["n_layers"]
    E, K = sizes.get("n_experts", 0), sizes.get("top_k", 0)
    ffn = (K * 3 * D * F + D * E) if E else 3 * D * F
    return 2 * L * (_attn_params(sizes) + ffn)


def logits_flops(sizes: Dict) -> int:
    return 2 * sizes["d_model"] * sizes["vocab_size"]


def causal_pairs(n: int, window=None) -> int:
    """(query, key) pairs of causal attention over n tokens, within
    ``window`` keys of each query if given."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    w = window
    return w * (w + 1) // 2 + (n - w) * w


def decode_valid(pos: int, ring: int, window=None) -> int:
    """Ring positions a decode query at position ``pos`` reads."""
    v = min(pos + 1, ring)
    return min(v, window) if window else v


def attn_flops(sizes: Dict, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs, every layer."""
    return 4 * sizes["n_layers"] * sizes["n_heads"] * sizes["head_dim"] * pairs


def prefill_attention(sizes: Dict, n: int) -> Tuple[int, int]:
    """(flops, bytes) of the prefill attention of a prompt of n true
    tokens over every layer: q, k, v read once, the output written once."""
    hd, hq, kv = sizes["head_dim"], sizes["n_heads"], sizes["n_kv_heads"]
    flops = attn_flops(sizes, causal_pairs(n, sizes.get("sliding_window")))
    nbytes = sizes["n_layers"] * n * (2 * hq + 2 * kv) * hd * BF16_BYTES
    return flops, nbytes


def decode_attention(sizes: Dict, valid: Iterable[int]) -> Tuple[int, int]:
    """(flops, bytes) of one decode attention call per layer over rows
    reading ``valid`` ring positions each: every valid K/V slot read once,
    q read and the output written once per row."""
    hd, hq, kv, L = (sizes["head_dim"], sizes["n_heads"], sizes["n_kv_heads"],
                     sizes["n_layers"])
    valid = list(valid)
    kv_bytes = sum(valid) * 2 * kv * hd * BF16_BYTES
    qo_bytes = len(valid) * 2 * hq * hd * BF16_BYTES
    return attn_flops(sizes, sum(valid)), L * (kv_bytes + qo_bytes)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def model_flops(sizes: Dict, prefill_lens: Iterable[int],
                decode_pos: Iterable[int]) -> int:
    """Model FLOPs of prefilling prompts of the given true lengths (logits
    of the last token only, as the engine takes them) and of decoding one
    token at each of the given positions."""
    mm, lg = matmul_flops_per_token(sizes), logits_flops(sizes)
    ring = sizes["ring"]
    total = 0
    for n in prefill_lens:
        total += n * mm + lg + prefill_attention(sizes, n)[0]
    for p in decode_pos:
        total += mm + lg + attn_flops(
            sizes, decode_valid(p, ring, sizes.get("sliding_window")))
    return total
