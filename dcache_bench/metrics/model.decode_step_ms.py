"""Host time of an engine step that admitted nothing (a pure decode step
of the whole batch, ending in the sampler's copy to the host), taken as
the sum over all such steps of the window divided by their count, so the
host clock spans the many steps together."""


def read(ctx):
    pure = [s for s in ctx.steps if not s.admitted]
    if not pure:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in pure) / len(pure)
