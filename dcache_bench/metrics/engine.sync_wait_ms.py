"""Host time blocked in copies to the host in a pure decode step: the
``engine.sync`` spans (the sampled tokens and the positions) of the
traced window's ``engine.step`` spans that admitted nothing, their sum
over the count of those steps. Mostly the wait for the device to finish
the step's work."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    pure = {s.id for s in spans.pure_steps(got)}
    if not pure:
        return None
    return 1e-6 * sum(s.end - s.start for s in got
                      if s.name == "engine.sync" and s.parent in pure) / len(pure)
