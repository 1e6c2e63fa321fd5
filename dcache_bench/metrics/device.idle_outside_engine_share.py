"""Share of the traced window in which no operation ran on the device
while the host was in no ``engine.step`` span: the idle time of the
client's own work between steps (the closed loop's bookkeeping and next
submits)."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    tr = ctx.trace
    if not got or tr.window_s <= 0:
        return None
    gaps = spans.idle(tr)
    steps = spans.intervals((s for s in got if s.name == "engine.step"),
                            tr.t0, tr.t1)
    outside = sum(b - a for a, b in gaps) - spans.overlap(gaps, steps)
    return 100.0 * outside / (tr.t1 - tr.t0)
