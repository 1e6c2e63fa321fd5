"""Model FLOPs of the traced window over the window's length at the card's
dense bf16 peak (989 TFLOP/s, H100 SXM at 700 W): prompt tokens prefilled
at their true lengths and tokens decoded, at the configuration's widths,
active experts only, as the architecture counts them (``model_flops``)."""
from dcache_bench import arith


def read(ctx):
    tr, count = ctx.trace, getattr(ctx.arch, "model_flops", None)
    if tr is None or tr.window_s <= 0 or count is None:
        return None
    lens = [n for s in ctx.traced_steps for n in s.prefill_lens]
    pos = [p for s in ctx.traced_steps for p in s.decode_pos]
    flops = count(ctx.sizes, lens, pos)
    if flops is None:
        return None
    return 100.0 * flops / (tr.window_s * arith.PEAK_BF16_FLOPS)
