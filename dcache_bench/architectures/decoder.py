"""A pre-norm decoder of grouped-query rotary attention and a SwiGLU FFN,
dense or with top-k routed experts of one width on every layer (granite,
Mixtral): its sizes, its weights, the port's ``ModelConfig`` fields and its
work counts.

An architecture module is found by name (a configuration's
``"architecture"``, see ``harness.load_architecture``) and keeps this
interface; it imports nothing of the program:

- ``sizes(cfg)``: the sizes the program's fields, the weights, the reference
  and the counts share, from a configuration file; ``max_batch`` and
  ``max_len`` among them;
- ``make_params(sizes, seed, device)``: the weights, made on the device;
- ``model_fields(name, sizes)``: the port's ``ModelConfig`` keyword
  arguments as plain data, a nested dataclass as a dict;
- ``weight_params``, ``cache_bytes``, ``model_flops``, ``prefill_attention``,
  ``decode_attention`` and ``expert_work``: the work counts the readers take
  (each ``(flops, bytes)`` pair over every layer); one that returns None, or
  is absent, leaves its metric unread.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from dcache_bench import weights
from dcache_bench.arith import BF16_BYTES, causal_pairs

SUPPORTED = {"hidden_act": "silu", "attention_bias": False,
             "torch_dtype": "bfloat16"}


def sizes(cfg: Dict) -> Dict:
    """From a configuration file's (Hugging Face style) keys."""
    for k, v in SUPPORTED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"configuration: {k}={cfg[k]!r} is not served "
                             f"(only {v!r})")
    serve = cfg["serve"]
    window = cfg.get("sliding_window")
    return {
        "family": cfg["family"], "n_layers": cfg["num_hidden_layers"],
        "d_model": cfg["hidden_size"], "d_ff": cfg["intermediate_size"],
        "n_heads": cfg["num_attention_heads"],
        "n_kv_heads": cfg["num_key_value_heads"], "head_dim": cfg["head_dim"],
        "vocab_size": cfg["vocab_size"], "rope_theta": cfg["rope_theta"],
        "norm_eps": cfg["rms_norm_eps"], "tie_embeddings": cfg["tie_word_embeddings"],
        "sliding_window": window, "n_experts": cfg.get("num_local_experts", 0),
        "top_k": cfg.get("num_experts_per_tok", 0), "dtype": cfg["torch_dtype"],
        "max_batch": serve["max_batch"], "max_len": serve["max_len"],
        "ring": min(serve["max_len"], window or serve["max_len"]),
    }


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """Each kind of leaf drawn for all layers at once (``weights.drawer``),
    in the layout ``ServingEngine`` takes."""
    draw = weights.drawer(seed, device, sizes["dtype"])
    L, D, F = sizes["n_layers"], sizes["d_model"], sizes["d_ff"]
    Q, KV = sizes["n_heads"] * sizes["head_dim"], sizes["n_kv_heads"] * sizes["head_dim"]
    V = weights.padded_vocab(sizes["vocab_size"])
    E = sizes.get("n_experts", 0)

    out_scale = L ** -0.5
    p = {"embed": draw((V, D), D ** -0.5),
         "final_norm": draw((D,), 0.1, 1.0)}
    if not sizes["tie_embeddings"]:
        p["unembed"] = draw((D, V), D ** -0.5)
    stacked = {"norm1": draw((L, D), 0.1, 1.0), "norm2": draw((L, D), 0.1, 1.0),
               "wq": draw((L, D, Q), D ** -0.5), "wk": draw((L, D, KV), D ** -0.5),
               "wv": draw((L, D, KV), D ** -0.5),
               "wo": draw((L, Q, D), Q ** -0.5 * out_scale)}
    if E:
        stacked.update(router=draw((L, D, E), D ** -0.5),
                       we_gate=draw((L, E, D, F), D ** -0.5),
                       we_up=draw((L, E, D, F), D ** -0.5),
                       we_down=draw((L, E, F, D), F ** -0.5 * out_scale))
    else:
        stacked.update(w_gate=draw((L, D, F), D ** -0.5),
                       w_up=draw((L, D, F), D ** -0.5),
                       w_down=draw((L, F, D), F ** -0.5 * out_scale))
    ffn_keys = (("router", "we_gate", "we_up", "we_down") if E
                else ("w_gate", "w_up", "w_down"))
    p["layers"] = [
        {"norm1": stacked["norm1"][l], "norm2": stacked["norm2"][l],
         "attn": {k: stacked[k][l] for k in ("wq", "wk", "wv", "wo")},
         ("moe" if E else "mlp"): {k: stacked[k][l] for k in ffn_keys}}
        for l in range(L)]
    return p


def model_fields(name: str, sizes: Dict) -> Dict:
    moe = ({"n_experts": sizes["n_experts"], "top_k": sizes["top_k"],
            "interleave": 1} if sizes.get("n_experts") else None)
    return {
        "name": name, "family": sizes["family"], "n_layers": sizes["n_layers"],
        "d_model": sizes["d_model"], "n_heads": sizes["n_heads"],
        "n_kv_heads": sizes["n_kv_heads"], "d_ff": sizes["d_ff"],
        "vocab_size": sizes["vocab_size"], "head_dim": sizes["head_dim"],
        "rope_theta": sizes["rope_theta"], "sliding_window": sizes.get("sliding_window"),
        "moe": moe, "norm_eps": sizes["norm_eps"],
        "tie_embeddings": sizes["tie_embeddings"], "dtype": sizes["dtype"]}


# ---------------------------------------------------------------------------
# work counts: what the inputs need (a prompt's true length, a decode row's
# valid ring positions, a token's active experts), not what is padded
# ---------------------------------------------------------------------------

def attn_params(sizes: Dict) -> int:
    D, hd = sizes["d_model"], sizes["head_dim"]
    q, kv = sizes["n_heads"] * hd, sizes["n_kv_heads"] * hd
    return 2 * D * q + 2 * D * kv


def weight_params(sizes: Dict) -> int:
    """Parameters of the decoder (embedding and head, all experts)."""
    D, F, L = sizes["d_model"], sizes["d_ff"], sizes["n_layers"]
    V = weights.padded_vocab(sizes["vocab_size"])
    layer = attn_params(sizes) + 2 * D
    E = sizes.get("n_experts", 0)
    layer += (E * 3 * D * F + D * E) if E else 3 * D * F
    head = V * D * (1 if sizes["tie_embeddings"] else 2)
    return L * layer + head + D


def cache_bytes(sizes: Dict, max_batch: int, max_len: int) -> int:
    """The K/V ring the engine reserves: every layer, every slot."""
    C = min(max_len, sizes.get("sliding_window") or max_len)
    return (sizes["n_layers"] * max_batch * C * 2 * sizes["n_kv_heads"]
            * sizes["head_dim"] * BF16_BYTES)


def matmul_flops_per_token(sizes: Dict) -> int:
    """2 x the weights a token multiplies in the layers: attention's
    projections, the router and its top-k experts (or the dense FFN)."""
    D, F, L = sizes["d_model"], sizes["d_ff"], sizes["n_layers"]
    E, K = sizes.get("n_experts", 0), sizes.get("top_k", 0)
    ffn = (K * 3 * D * F + D * E) if E else 3 * D * F
    return 2 * L * (attn_params(sizes) + ffn)


def logits_flops(sizes: Dict) -> int:
    return 2 * sizes["d_model"] * sizes["vocab_size"]


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


def decode_attention(sizes: Dict, decode_pos: Iterable[int]) -> Tuple[int, int]:
    """(flops, bytes) of one decode attention call per layer over rows at
    ``decode_pos``: each row's valid K/V slots read once, q read and the
    output written once per row."""
    hd, hq, kv, L = (sizes["head_dim"], sizes["n_heads"], sizes["n_kv_heads"],
                     sizes["n_layers"])
    valid = [decode_valid(p, sizes["ring"], sizes.get("sliding_window"))
             for p in decode_pos]
    kv_bytes = sum(valid) * 2 * kv * hd * BF16_BYTES
    qo_bytes = len(valid) * 2 * hq * hd * BF16_BYTES
    return attn_flops(sizes, sum(valid)), L * (kv_bytes + qo_bytes)


def model_flops(sizes: Dict, prefill_lens: Iterable[int],
                decode_pos: Iterable[int]) -> int:
    """Model FLOPs of prefilling prompts of the given true lengths (logits
    of the last token only, as the engine takes them) and of decoding one
    token at each of the given positions."""
    mm, lg = matmul_flops_per_token(sizes), logits_flops(sizes)
    total = 0
    for n in prefill_lens:
        total += n * mm + lg + prefill_attention(sizes, n)[0]
    for p in decode_pos:
        total += mm + lg + attn_flops(
            sizes, decode_valid(p, sizes["ring"], sizes.get("sliding_window")))
    return total


def expert_work(sizes: Dict, rows: int) -> Optional[Tuple[int, int]]:
    """(flops, bytes) of the expert products of one call of every expert
    layer over ``rows`` true tokens: rows x top_k routed SwiGLU products,
    and every expert's weights read once a layer; None for a dense model."""
    E = sizes.get("n_experts", 0)
    if not E:
        return None
    D, F, K, L = sizes["d_model"], sizes["d_ff"], sizes["top_k"], sizes["n_layers"]
    return L * rows * K * 2 * 3 * D * F, L * E * 3 * D * F * BF16_BYTES
