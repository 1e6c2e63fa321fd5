"""A dense decoder whose attention RMS-normalises q and k over each head,
with gains of their own, before the rotary embedding (as OLMo-2 does), and
is the decoder otherwise: an architecture that ``architectures/decoder.py``
cannot build, added to a tree as ``architectures/qk_norm_decoder.py``."""
from dcache_bench import weights
from dcache_bench.architectures import decoder as base

SUPPORTED = base.SUPPORTED


def sizes(cfg):
    s = base.sizes(cfg)
    if s["n_experts"]:
        raise ValueError("qk_norm_decoder: a dense FFN only")
    return s


def make_params(sizes, seed, device):
    """The decoder's weights, then the per-head gains ``q_norm`` and
    ``k_norm`` of every layer from a second draw of the seed."""
    p = base.make_params(sizes, seed, device)
    draw = weights.drawer(seed + 1, device, sizes["dtype"])
    L, hd = sizes["n_layers"], sizes["head_dim"]
    q_norm, k_norm = draw((L, hd), 0.1, 1.0), draw((L, hd), 0.1, 1.0)
    for lp, qn, kn in zip(p["layers"], q_norm, k_norm):
        lp["attn"].update(q_norm=qn, k_norm=kn)
    return p


def model_fields(name, sizes):
    return dict(base.model_fields(name, sizes), qk_norm=True)


def weight_params(sizes):
    return base.weight_params(sizes) + 2 * sizes["n_layers"] * sizes["head_dim"]


cache_bytes = base.cache_bytes
model_flops = base.model_flops
prefill_attention = base.prefill_attention
decode_attention = base.decode_attention
