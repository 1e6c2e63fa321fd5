"""The expert products' share of their roofline: the least time the card
could take for the traced steps' expert FFNs over the device time of the
operations launched inside ``moe.experts`` spans (the expert products
alone, without the router, dispatch and combine). The least time counts,
for each call of the expert layers, the true routed work as the
architecture counts it (``expert_work``: for the decoder, (true prompt
tokens or decode rows) x top_k x 2 x 3 x D x F FLOPs a layer, and every
expert's weights read once a layer), at 989 TFLOP/s and 3.35 TB/s."""
from dcache_bench import arith, spans


def read(ctx):
    count = getattr(ctx.arch, "expert_work", None)
    if count is None or count(ctx.sizes, 1) is None:
        return None
    got = spans.of(ctx)
    if not got:
        return None
    experts = [x for x in got if x.name == "moe.experts"]
    tr = spans.with_ranges(ctx.trace, "moe.experts", experts)
    t = tr.device_s_launched_in("moe.experts")
    if t <= 0:
        return None

    def call(tokens):
        return arith.least_seconds(*count(ctx.sizes, tokens))

    least = 0.0
    for st in ctx.traced_steps:
        least += sum(call(n) for n in st.prefill_lens)
        if st.decode_pos:
            least += call(len(st.decode_pos))
    return 100.0 * least / t if least else None
