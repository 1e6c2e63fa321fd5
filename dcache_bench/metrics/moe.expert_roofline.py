"""The expert products' share of their roofline: the least time the card
could take for the traced steps' expert FFNs over the device time of the
operations launched inside ``moe.experts`` spans (the expert products
alone, without the router, dispatch and combine). The least time counts,
for each expert layer call, the true routed work: (true prompt tokens or
decode rows) x top_k x 2 x 3 x D x F FLOPs, and every expert's weights
read once (E x 3 x D x F bf16), at 989 TFLOP/s and 3.35 TB/s."""
from dcache_bench import arith, spans


def read(ctx):
    got = spans.of(ctx)
    s = ctx.sizes
    if not got or not s.get("n_experts"):
        return None
    experts = [x for x in got if x.name == "moe.experts"]
    tr = spans.with_ranges(ctx.trace, "moe.experts", experts)
    t = tr.device_s_launched_in("moe.experts")
    if t <= 0:
        return None
    D, F, E, K, L = (s["d_model"], s["d_ff"], s["n_experts"], s["top_k"],
                     s["n_layers"])
    weights = E * 3 * D * F * arith.BF16_BYTES

    def call(tokens):
        return L * arith.least_seconds(tokens * K * 2 * 3 * D * F, weights)

    least = 0.0
    for st in ctx.traced_steps:
        least += sum(call(n) for n in st.prefill_lens)
        if st.decode_pos:
            least += call(len(st.decode_pos))
    return 100.0 * least / t if least else None
