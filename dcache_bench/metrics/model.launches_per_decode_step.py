"""Launch calls (kernel launches, copies and sets the host enqueues) per
pure decode step in the trace: the host dispatch that a captured step
(a CUDA graph) would remove."""


def read(ctx):
    if ctx.trace is None:
        return None
    n, steps = ctx.trace.launches_in("bench.step.decode")
    return n / steps if steps else None
