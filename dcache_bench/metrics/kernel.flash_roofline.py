"""The prefill attention kernel's share of its roofline: the least time
the card could take for the traced prefills' attention (true prompt
lengths, causal, within the window if any; q, k, v read once and the
output written once, as the architecture counts them, at bf16 peak and
HBM bandwidth) over the device time of the flash kernel in the trace."""
from dcache_bench import arith


def read(ctx):
    tr, count = ctx.trace, getattr(ctx.arch, "prefill_attention", None)
    if tr is None or count is None:
        return None
    t = tr.device_s("flash_kernel")
    lens = [n for s in ctx.traced_steps for n in s.prefill_lens]
    if t <= 0 or not lens:
        return None
    work = [count(ctx.sizes, n) for n in lens]
    if any(w is None for w in work):
        return None
    return 100.0 * sum(arith.least_seconds(*w) for w in work) / t
