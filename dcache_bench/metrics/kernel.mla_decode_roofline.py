"""The latent decode kernel's share of its roofline: the least time the
card could take for the traced decode steps' latent attention (each active
row's valid latent positions read once, with q and the output, and the
absorbed products, as the architecture counts them: ``mla_decode_attention``)
over the device time of the kernel, found by its own name
(``mla_latent_kernel``, which no other reader's needle matches)."""
from dcache_bench import arith


def read(ctx):
    tr, count = ctx.trace, getattr(ctx.arch, "mla_decode_attention", None)
    if tr is None or count is None:
        return None
    t = tr.device_s("mla_latent_kernel")
    if t <= 0:
        return None
    least = sum(arith.least_seconds(*count(ctx.sizes, st.decode_pos))
                for st in ctx.traced_steps if st.decode_pos)
    return 100.0 * least / t if least else None
