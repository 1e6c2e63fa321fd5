"""The decode attention kernel's share of its roofline: the least time the
card could take for the traced decode steps' attention (each active row's
valid ring positions read once, K and V, with q and the output, as the
architecture counts them) over the device time of the decode kernel in
the trace."""
from dcache_bench import arith


def read(ctx):
    tr, count = ctx.trace, getattr(ctx.arch, "decode_attention", None)
    if tr is None or count is None:
        return None
    t = tr.device_s("decode_kernel")
    if t <= 0:
        return None
    least = 0.0
    for st in ctx.traced_steps:
        work = count(ctx.sizes, st.decode_pos) if st.decode_pos else None
        if work is not None:
            least += arith.least_seconds(*work)
    return 100.0 * least / t if least else None
