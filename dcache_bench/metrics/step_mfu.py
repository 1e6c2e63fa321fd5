"""Model FLOPs of the traced window over the window's length at the card's
dense bf16 peak (989 TFLOP/s, H100 SXM at 700 W): prompt tokens prefilled
at their true lengths and tokens decoded, at the configuration's widths,
active experts only (arith.model_flops)."""
from dcache_bench import arith


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    lens = [n for s in ctx.traced_steps for n in s.prefill_lens]
    pos = [p for s in ctx.traced_steps for p in s.decode_pos]
    flops = arith.model_flops(ctx.sizes, lens, pos)
    return 100.0 * flops / (tr.window_s * arith.PEAK_BF16_FLOPS)
