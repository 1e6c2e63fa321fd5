"""Share of the traced window in which no operation ran on the device
while the host was inside the model's calls (``model.decode`` or
``model.prefill`` spans): the idle time the model's own host dispatch
leaves."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    tr = ctx.trace
    if not got or tr.window_s <= 0:
        return None
    calls = spans.intervals((s for s in got
                             if s.name in ("model.decode", "model.prefill")),
                            tr.t0, tr.t1)
    return 100.0 * spans.overlap(spans.idle(tr), calls) / (tr.t1 - tr.t0)
