"""Pad tokens of the traced window's prefills as a share of the tokens
prefilled: 100 x sum(padded - tokens) / sum(padded) over the
``engine.admit`` spans that started in the window (a prompt of ``tokens``
is prefilled at its bucket, ``padded``)."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    admits = [s for s in got if s.name == "engine.admit" and t0 <= s.start <= t1]
    padded = sum(s.padded for s in admits)
    if not padded:
        return None
    return 100.0 * sum(s.padded - s.tokens for s in admits) / padded
