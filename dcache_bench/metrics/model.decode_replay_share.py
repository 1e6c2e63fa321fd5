"""Share of the traced window's pure decode steps (``engine.step`` spans
that admitted nothing) whose ``model.decode`` span holds a ``model.replay``
span: the steps the program served by replaying a captured decode step (a
CUDA graph) instead of launching its kernels one by one. A program that
records spans but never replays reads 0; one with no spans, or a window
with no pure decode step, gives no value."""
from dcache_bench import spans


def read(ctx):
    got = spans.of(ctx)
    if not got:
        return None
    pure = {s.id for s in spans.pure_steps(got)}
    if not pure:
        return None
    step_of = {s.id: s.parent for s in got
               if s.name == "model.decode" and s.parent in pure}
    replayed = {step_of[s.parent] for s in got
                if s.name == "model.replay" and s.parent in step_of}
    return 100.0 * len(replayed) / len(pure)
