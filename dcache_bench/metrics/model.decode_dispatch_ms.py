"""Host time of the ``decode_step`` call in a pure decode step: the
``model.decode`` spans of the traced window's ``engine.step`` spans that
admitted nothing, their sum over the count of those steps. The call
returns once its work is enqueued, so this is the model's host dispatch
(with any wait the device forces on it)."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    pure = {s.id for s in spans.pure_steps(got)}
    if not pure:
        return None
    return 1e-6 * sum(s.end - s.start for s in got
                      if s.name == "model.decode" and s.parent in pure) / len(pure)
