"""Busy slots per engine step over the window, as a share of the slots:
the active rows each ``step()`` returns over ``max_batch``. Idle slots
are batch rows the lockstep decode computes for nothing."""


def read(ctx):
    steps = ctx.steps
    if not steps:
        return None
    return 100.0 * sum(s.active for s in steps) / (len(steps) * ctx.sizes["max_batch"])
