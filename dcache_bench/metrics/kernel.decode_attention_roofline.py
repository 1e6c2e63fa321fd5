"""The decode attention kernel's share of its roofline: the least time the
card could take for the traced decode steps' attention (each active row's
valid ring positions read once, K and V, with q and the output) over the
device time of the decode kernel in the trace."""
from dcache_bench import arith


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.device_s("decode_kernel")
    if t <= 0:
        return None
    s = ctx.sizes
    least = 0.0
    for st in ctx.traced_steps:
        valid = [arith.decode_valid(p, s["ring"], s.get("sliding_window"))
                 for p in st.decode_pos]
        if valid:
            least += arith.least_seconds(*arith.decode_attention(s, valid))
    return 100.0 * least / t if least else None
