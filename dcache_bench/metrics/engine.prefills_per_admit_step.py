"""Mean prefills of the window's steps that admitted: the increase of the
engine's ``prefills`` counter over each such ``step()``. Single-row
prefills run one after another, so this counts the serial wait that a
first token sees in its step."""


def read(ctx):
    admitted = [s.admitted for s in ctx.steps if s.admitted]
    return sum(admitted) / len(admitted) if admitted else None
