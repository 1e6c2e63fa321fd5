"""DeepSeek-V2 (Lite): latent attention (MLA, no q compression) and a
fine-grained expert layer (softmax over all routed experts, top-k not
renormalised, shared experts beside them), its first layers dense, yarn
rope. Its sizes, its weights, the port's ``ModelConfig`` fields and its
work counts, with ``decoder.py``'s interface; it imports nothing of the
program.

Work counts (each ``(flops, bytes)`` over every layer, bytes of bf16), at
the least work of each phase over a latent cache; written out here so that
the yardstick does not move:

- ``weight_params``: embedding, untied head and final norm; per layer two
  norms and MLA's ``wq`` D x H(nope + rope), ``wkv_a`` D x (r + rope), the
  latent's norm r, ``wkv_b`` r x H(nope + v), ``wo`` Hv x D; the dense
  layers' 3 D F_dense; each expert layer's router D E, E routed experts of
  3 D F and the shared experts' 3 D sF (DeepSeek-V2-Lite: 15,706,484,224);
- ``cache_bytes``: the latent ring, L x slots x max_len x (r + rope) x 2;
- ``model_flops``: a prefill in the decompressed form at the true length n:
  n x 2 x (the per-token projections, ``wkv_b`` included, and the FFN: the
  router, the top-k routed experts and the shared ones, or the dense FFN)
  plus H x (nope + rope + v) x 2 FLOPs a causal pair a layer; a decode row
  in the absorbed form: 2 x (the projections with W_UK, H nope r, and W_UV,
  H r v, in place of ``wkv_b``, and the FFN) plus H x (2r + rope) x 2 FLOPs
  a valid position a layer; the last token's logits, 2 D V, once a prefill
  and once a row;
- ``prefill_attention``: H x (nope + rope + v) x 2 FLOPs a causal pair a
  layer; q and k (H x (nope + rope)), v and the output (H x v) a token
  read or written once;
- ``expert_work``: the routed top-k products at the expert width, rows x k
  x 2 x 3 D F a layer, and all E experts' weights read once a layer call;
- ``mla_decode_attention``: each row's valid latent positions read once
  ((r + rope) x 2 bytes a layer), q (H (r + rope)) and the output (H r)
  read or written once a row, and H x (2r + rope) x 2 FLOPs a valid
  position.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

from dcache_bench import weights
from dcache_bench.arith import BF16_BYTES, causal_pairs

# what the port serves of the published config's switches
SUPPORTED = {"hidden_act": "silu", "attention_bias": False,
             "torch_dtype": "bfloat16", "q_lora_rank": None,
             "topk_method": "greedy", "scoring_func": "softmax",
             "norm_topk_prob": False, "routed_scaling_factor": 1,
             "moe_layer_freq": 1, "n_group": 1, "topk_group": 1}


def sizes(cfg: Dict) -> Dict:
    """From a configuration file's (Hugging Face style) keys."""
    for k, v in SUPPORTED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f"configuration: {k}={cfg[k]!r} is not served "
                             f"(only {v!r})")
    ys = cfg["rope_scaling"]
    if ys.get("type") != "yarn":
        raise ValueError(f"configuration: rope_scaling {ys!r} is not yarn")
    serve = cfg["serve"]
    return {
        "family": cfg["family"], "n_layers": cfg["num_hidden_layers"],
        "d_model": cfg["hidden_size"], "d_ff": cfg["intermediate_size"],
        "d_expert": cfg["moe_intermediate_size"],
        "n_dense": cfg["first_k_dense_replace"],
        "n_heads": cfg["num_attention_heads"],
        "kv_rank": cfg["kv_lora_rank"], "nope": cfg["qk_nope_head_dim"],
        "rope": cfg["qk_rope_head_dim"], "v_dim": cfg["v_head_dim"],
        "vocab_size": cfg["vocab_size"], "rope_theta": cfg["rope_theta"],
        "yarn": {k: ys[k] for k in ("factor", "original_max_position_embeddings",
                                    "beta_fast", "beta_slow", "mscale",
                                    "mscale_all_dim")},
        "norm_eps": cfg["rms_norm_eps"], "tie_embeddings": cfg["tie_word_embeddings"],
        "n_experts": cfg["n_routed_experts"], "top_k": cfg["num_experts_per_tok"],
        "n_shared": cfg["n_shared_experts"], "dtype": cfg["torch_dtype"],
        "max_batch": serve["max_batch"], "max_len": serve["max_len"],
        "ring": serve["max_len"],
    }


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """Each kind of leaf drawn for all its layers at once
    (``weights.drawer``), in the layout ``ServingEngine`` takes: the dense
    layers' FFN ``mlp``, the others' ``moe``; MLA's ``attn``."""
    draw = weights.drawer(seed, device, sizes["dtype"])
    L, D, H = sizes["n_layers"], sizes["d_model"], sizes["n_heads"]
    r, nope, rope, vd = sizes["kv_rank"], sizes["nope"], sizes["rope"], sizes["v_dim"]
    Ld, F, Fd = sizes["n_dense"], sizes["d_expert"], sizes["d_ff"]
    Lm, E, S = L - Ld, sizes["n_experts"], sizes["n_shared"] * sizes["d_expert"]
    V = weights.padded_vocab(sizes["vocab_size"])

    out_scale = L ** -0.5
    p = {"embed": draw((V, D), D ** -0.5),
         "final_norm": draw((D,), 0.1, 1.0)}
    if not sizes["tie_embeddings"]:
        p["unembed"] = draw((D, V), D ** -0.5)
    st = {"norm1": draw((L, D), 0.1, 1.0), "norm2": draw((L, D), 0.1, 1.0),
          "wq": draw((L, D, H * (nope + rope)), D ** -0.5),
          "wkv_a": draw((L, D, r + rope), D ** -0.5),
          "kv_norm": draw((L, r), 0.1, 1.0),
          "wkv_b": draw((L, r, H * (nope + vd)), r ** -0.5),
          "wo": draw((L, H * vd, D), (H * vd) ** -0.5 * out_scale)}
    dense = {"w_gate": draw((Ld, D, Fd), D ** -0.5), "w_up": draw((Ld, D, Fd), D ** -0.5),
             "w_down": draw((Ld, Fd, D), Fd ** -0.5 * out_scale)}
    moe = {"router": draw((Lm, D, E), D ** -0.5),
           "we_gate": draw((Lm, E, D, F), D ** -0.5),
           "we_up": draw((Lm, E, D, F), D ** -0.5),
           "we_down": draw((Lm, E, F, D), F ** -0.5 * out_scale),
           "ws_gate": draw((Lm, D, S), D ** -0.5), "ws_up": draw((Lm, D, S), D ** -0.5),
           "ws_down": draw((Lm, S, D), S ** -0.5 * out_scale)}
    layers = []
    for l in range(L):
        lp = {"norm1": st["norm1"][l], "norm2": st["norm2"][l],
              "attn": {k: st[k][l] for k in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")}}
        if l < Ld:
            lp["mlp"] = {k: t[l] for k, t in dense.items()}
        else:
            lp["moe"] = {k: t[l - Ld] for k, t in moe.items()}
        layers.append(lp)
    p["layers"] = layers
    return p


def model_fields(name: str, sizes: Dict) -> Dict:
    return {
        "name": name, "family": sizes["family"], "n_layers": sizes["n_layers"],
        "d_model": sizes["d_model"], "n_heads": sizes["n_heads"],
        "n_kv_heads": sizes["n_heads"], "d_ff": sizes["d_ff"],
        "vocab_size": sizes["vocab_size"],
        "head_dim": sizes["nope"] + sizes["rope"], "rope_theta": sizes["rope_theta"],
        "moe": {"n_experts": sizes["n_experts"], "top_k": sizes["top_k"],
                "interleave": 1, "n_shared_experts": sizes["n_shared"],
                "d_expert": sizes["d_expert"], "n_dense_layers": sizes["n_dense"],
                "scoring": "softmax_topk"},
        "norm_eps": sizes["norm_eps"], "tie_embeddings": sizes["tie_embeddings"],
        "dtype": sizes["dtype"], "kv_lora_rank": sizes["kv_rank"],
        "qk_nope_head_dim": sizes["nope"], "qk_rope_head_dim": sizes["rope"],
        "v_head_dim": sizes["v_dim"], "rope_scaling": dict(sizes["yarn"])}


# ---------------------------------------------------------------------------
# work counts: what the inputs need (a prompt's true length, a decode row's
# valid ring positions, a token's active experts), not what is padded
# ---------------------------------------------------------------------------

def _attn_params(sizes: Dict) -> int:
    D, H = sizes["d_model"], sizes["n_heads"]
    r, nope, rope, vd = sizes["kv_rank"], sizes["nope"], sizes["rope"], sizes["v_dim"]
    return (D * H * (nope + rope) + D * (r + rope) + r + r * H * (nope + vd)
            + H * vd * D)


def weight_params(sizes: Dict) -> int:
    D, L, Ld = sizes["d_model"], sizes["n_layers"], sizes["n_dense"]
    F, E = sizes["d_expert"], sizes["n_experts"]
    V = weights.padded_vocab(sizes["vocab_size"])
    dense = 3 * D * sizes["d_ff"]
    moe = D * E + E * 3 * D * F + 3 * D * sizes["n_shared"] * F
    head = V * D * (1 if sizes["tie_embeddings"] else 2)
    return L * (_attn_params(sizes) + 2 * D) + Ld * dense + (L - Ld) * moe + head + D


def cache_bytes(sizes: Dict, max_batch: int, max_len: int) -> int:
    """The latent ring the engine reserves: every layer, every slot."""
    return (sizes["n_layers"] * max_batch * max_len
            * (sizes["kv_rank"] + sizes["rope"]) * BF16_BYTES)


def _ffn_flops(sizes: Dict) -> int:
    """2 x the weights a token multiplies in the FFNs of all layers."""
    D, F, Ld = sizes["d_model"], sizes["d_expert"], sizes["n_dense"]
    moe = D * sizes["n_experts"] + sizes["top_k"] * 3 * D * F \
        + 3 * D * sizes["n_shared"] * F
    return 2 * (Ld * 3 * D * sizes["d_ff"] + (sizes["n_layers"] - Ld) * moe)


def _proj_flops(sizes: Dict, absorbed: bool) -> int:
    """2 x the attention weights a token multiplies over all layers: the
    decompressing ``wkv_b`` at a prefill, W_UK and W_UV at a decode row."""
    D, H = sizes["d_model"], sizes["n_heads"]
    r, nope, rope, vd = sizes["kv_rank"], sizes["nope"], sizes["rope"], sizes["v_dim"]
    mid = H * nope * r + H * r * vd if absorbed else r * H * (nope + vd)
    return 2 * sizes["n_layers"] * (D * H * (nope + rope) + D * (r + rope) + mid
                                    + H * vd * D)


def _pair_flops(sizes: Dict) -> int:
    """Prefill attention FLOPs a causal pair, every layer."""
    return (2 * sizes["n_layers"] * sizes["n_heads"]
            * (sizes["nope"] + sizes["rope"] + sizes["v_dim"]))


def _position_flops(sizes: Dict) -> int:
    """Absorbed decode attention FLOPs a valid position, every layer."""
    return (2 * sizes["n_layers"] * sizes["n_heads"]
            * (2 * sizes["kv_rank"] + sizes["rope"]))


def _valid(pos: int, ring: int) -> int:
    return min(pos + 1, ring)


def prefill_attention(sizes: Dict, n: int) -> Tuple[int, int]:
    H, qk, vd = sizes["n_heads"], sizes["nope"] + sizes["rope"], sizes["v_dim"]
    nbytes = sizes["n_layers"] * n * H * (2 * qk + 2 * vd) * BF16_BYTES
    return _pair_flops(sizes) * causal_pairs(n), nbytes


def mla_decode_attention(sizes: Dict, decode_pos: Iterable[int]) -> Tuple[int, int]:
    valid = [_valid(p, sizes["ring"]) for p in decode_pos]
    H, r, rope = sizes["n_heads"], sizes["kv_rank"], sizes["rope"]
    ring_bytes = sum(valid) * (r + rope) * BF16_BYTES
    qo_bytes = len(valid) * H * (2 * r + rope) * BF16_BYTES
    return _position_flops(sizes) * sum(valid), sizes["n_layers"] * (ring_bytes + qo_bytes)


def model_flops(sizes: Dict, prefill_lens: Iterable[int],
                decode_pos: Iterable[int]) -> int:
    ffn, lg = _ffn_flops(sizes), 2 * sizes["d_model"] * sizes["vocab_size"]
    pre, dec = _proj_flops(sizes, False) + ffn, _proj_flops(sizes, True) + ffn
    total = 0
    for n in prefill_lens:
        total += n * pre + lg + _pair_flops(sizes) * causal_pairs(n)
    for p in decode_pos:
        total += dec + lg + _position_flops(sizes) * _valid(p, sizes["ring"])
    return total


def expert_work(sizes: Dict, rows: int) -> Tuple[int, int]:
    D, F, E = sizes["d_model"], sizes["d_expert"], sizes["n_experts"]
    Lm = sizes["n_layers"] - sizes["n_dense"]
    return Lm * rows * sizes["top_k"] * 2 * 3 * D * F, Lm * E * 3 * D * F * BF16_BYTES
