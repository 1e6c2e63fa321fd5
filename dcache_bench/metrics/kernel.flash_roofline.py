"""The prefill attention kernel's share of its roofline: the least time
the card could take for the traced prefills' attention (true prompt
lengths, causal, within the window if any; q, k, v read once and the
output written once, at bf16 peak and HBM bandwidth) over the device time
of the flash kernel in the trace."""
from dcache_bench import arith


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.device_s("flash_kernel")
    lens = [n for s in ctx.traced_steps for n in s.prefill_lens]
    if t <= 0 or not lens:
        return None
    least = sum(arith.least_seconds(*arith.prefill_attention(ctx.sizes, n))
                for n in lens)
    return 100.0 * least / t
