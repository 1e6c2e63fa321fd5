"""Device time of the operations launched inside the program's
``mla.attend`` spans (each latent-attention layer call, prefill or decode:
projections, rope and ring write, decompression or absorption, the
attention kernel, the output projection), as a share of the device's busy
time in the trace; none where the program takes no such span."""
from dcache_bench import spans


def read(ctx):
    tr = ctx.trace
    got = spans.of(ctx)
    if not got or tr.busy_s <= 0:
        return None
    mla = [x for x in got if x.name == "mla.attend"]
    if not mla:
        return None
    t = spans.with_ranges(tr, "mla.attend", mla).device_s_launched_in("mla.attend")
    return 100.0 * t / tr.busy_s
