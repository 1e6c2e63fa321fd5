"""Mean wait of a call in the engine's queue: the ``engine.queue`` spans
(from the submit to the start of the call's admission, both in the
program) whose admission started in the traced window."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    waits = [s.end - s.start for s in got
             if s.name == "engine.queue" and t0 <= s.end <= t1]
    return 1e-6 * sum(waits) / len(waits) if waits else None
