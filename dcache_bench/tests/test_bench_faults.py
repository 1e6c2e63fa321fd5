"""A run whose timed path is broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU at a tiny size, with one fault planted in the program: a decode step
that leaves its state unchanged, half of the batch left out, or every
token altered where it is produced. (A cell on one chip has no exchange
between chips to leave out.) The unbroken run comes out correct."""
import pytest
import torch

from bench_tiny import EVERY_CELL, make_root
from dcache_bench import harness


def state_unchanged(engine_mod, monkeypatch):
    orig = engine_mod.decode_step

    def step(cfg, params, tokens, cache):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, cache = orig(cfg, params, tokens, cache)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache
    monkeypatch.setattr(engine_mod, "decode_step", step)


def half_batch(engine_mod, monkeypatch):
    orig = engine_mod.decode_step

    def step(cfg, params, tokens, cache):
        logits, cache = orig(cfg, params, tokens, cache)
        logits[logits.shape[0] // 2:] = 0.0
        return logits, cache
    monkeypatch.setattr(engine_mod, "decode_step", step)


def token_altered(engine_mod, monkeypatch):
    orig = engine_mod.sample

    def sample(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % 256
    monkeypatch.setattr(engine_mod, "sample", sample)


@pytest.mark.parametrize("cell", ["tiny-decide", "tiny-react"])
@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch, token_altered])
def test_a_fault_makes_the_run_not_correct(tmp_path, monkeypatch, cell, fault):
    from repro_torch.serving import engine as engine_mod

    if fault is not None:
        fault(engine_mod, monkeypatch)
    torch.manual_seed(0)
    r = harness.run(make_root(tmp_path), cell, 21, 3.0, trace=False, device="cpu")
    assert r["correct"] is (fault is None), r["check"]
    # every cell's metrics, and on tiny-react each timed one named for
    # mixtral-react too (granite-decide has no entries named for it)
    named = {f"{q}.mixtral-react" for q in EVERY_CELL if q != "setup_s"}
    assert set(r["metrics"]) == set(EVERY_CELL) | (named if cell == "tiny-react" else set())
