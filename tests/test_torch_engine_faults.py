"""The port's engine where it deviates from the reference's, and its
greedy parity with the JAX engine on the MoE and hybrid families.

1. A prompt whose power-of-two bucket is longer than the ring (a sliding
   window or attention chunk of 8) is prefilled at its exact length: a
   10-token prompt decodes to the logits (1e-5, fp32) and greedy tokens of
   an exact-length prefill. Padded to 16, ``pack_ring`` would keep the last
   8 *padded* positions and decode would read pad slots as in-window.
2. Decode samples each slot at its own temperature (the reference samples
   every decode token greedily): at temperature 0 sampling is the argmax
   and draws nothing; at temperature 1 two generator seeds diverge after
   the first token while the greedy slots of the same batch stay as they
   are in an all-greedy batch.
3. Reduced mixtral-8x22b, llama4-maverick-400b-a17b (4 layers) and
   hymba-1.5b at fp32 decode the JAX engine's greedy ``out_ids``, on
   prompts of at most 8 tokens, whose bucket fits the ring of 8 (longer
   padded prompts are where the two engines now differ, by item 1).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.sampler import sample

EXACT = dict(atol=1e-5, rtol=1e-5)
PROMPT10 = "abcdefghi"          # BOS + 9 bytes = 10 tokens, bucket 16


def port_setup(arch="dcache-agent-150m", seed=0, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=512,
                              dtype="float32", **kw)
    return cfg, tmodel.init_model(cfg, torch.Generator().manual_seed(seed), "cpu")


def spy_engine(monkeypatch, cfg, params, **kw):
    """An engine whose prefill lengths and decode logits are recorded."""
    seen = {"prefill": [], "logits": []}
    real_pre, real_dec = engine_mod.prefill_step, engine_mod.decode_step

    def pre(cfg_, p, batch, **k):
        seen["prefill"].append(batch["tokens"].shape[1])
        return real_pre(cfg_, p, batch, **k)

    def dec(cfg_, p, toks, cache):
        logits, cache = real_dec(cfg_, p, toks, cache)
        seen["logits"].append(logits[:, -1].clone())
        return logits, cache

    monkeypatch.setattr(engine_mod, "prefill_step", pre)
    monkeypatch.setattr(engine_mod, "decode_step", dec)
    return ServingEngine(cfg, params, device="cpu", **kw), seen


# ---------------------------------------------------------------------------
# 1. a padded bucket longer than the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [dict(sliding_window=8), dict(attn_chunk=8)],
                         ids=["window8", "chunk8"])
def test_long_bucket_decodes_as_exact_prefill(monkeypatch, mask):
    cfg, p = port_setup(**mask)
    eng, seen = spy_engine(monkeypatch, cfg, p, max_batch=1, max_len=64)
    req = eng.submit(PROMPT10, max_new_tokens=6)
    eng.run_until_done()
    ids = req.prompt_ids
    assert len(ids) == 10 and engine_mod._bucket(10, 64) == 16
    assert seen["prefill"] == [10]           # not the bucket of 16
    # the reference: an exact-length prefill, then decode on its own tokens
    cache, logits = tmodel.prefill_step(
        cfg, p, {"tokens": torch.tensor([ids], dtype=torch.int32)}, max_len=64)
    toks = [int(logits[0, -1].argmax())]
    for got in seen["logits"]:
        logits, cache = tmodel.decode_step(
            cfg, p, torch.tensor([[toks[-1]]], dtype=torch.int32), cache)
        np.testing.assert_allclose(got[0].numpy(), logits[0, -1].numpy(), **EXACT)
        toks.append(int(logits[0, -1].argmax()))
    assert req.out_ids == toks[:len(req.out_ids)]


def test_bucket_that_fits_the_ring_stays_padded(monkeypatch):
    """A window wider than the bucket keeps the reference's padding."""
    cfg, p = port_setup(sliding_window=16)
    eng, seen = spy_engine(monkeypatch, cfg, p, max_batch=1, max_len=64)
    eng.submit(PROMPT10, max_new_tokens=2)
    eng.run_until_done()
    assert seen["prefill"] == [16]


# ---------------------------------------------------------------------------
# 2. temperature at decode
# ---------------------------------------------------------------------------

def test_sample_per_row_temperature_zero_is_argmax_and_draws_nothing():
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        0, 3, (5, 300)).astype(np.float32))
    gen = torch.Generator().manual_seed(7)
    state = gen.get_state()
    out = sample(logits, gen, temperature=[0.0] * 5)
    assert out.dtype == torch.int32
    assert torch.equal(out, logits.argmax(-1).to(torch.int32))
    assert torch.equal(gen.get_state(), state)
    mixed = sample(logits, gen, temperature=[0.0, 1.0, 0.0, 2.0, 0.0])
    assert torch.equal(mixed[0::2], logits.argmax(-1).to(torch.int32)[0::2])


def run_mixed(cfg, p, seed, temps, prompts=("greedy prompt one", "hot",
                                            "greedy two")):
    eng = ServingEngine(cfg, p, max_batch=len(prompts), max_len=64,
                        device="cpu")
    eng._gen.manual_seed(seed)          # the generator temperature draws from
    reqs = [eng.submit(q, max_new_tokens=10, temperature=t)
            for q, t in zip(prompts, temps)]
    eng.run_until_done()
    return [r.out_ids for r in reqs]


def test_decode_honours_each_slot_temperature():
    cfg, p = port_setup()
    greedy = run_mixed(cfg, p, 0, [0.0, 0.0, 0.0])
    assert run_mixed(cfg, p, 5, [0.0, 0.0, 0.0]) == greedy  # seed unused
    a = run_mixed(cfg, p, 0, [0.0, 1.0, 0.0])
    b = run_mixed(cfg, p, 1, [0.0, 1.0, 0.0])
    # the greedy slots are those of the all-greedy batch, whatever the seed
    assert a[0] == b[0] == greedy[0] and a[2] == b[2] == greedy[2]
    # the hot slot: each seed its own tokens past the first
    assert len(a[1]) > 1 and len(b[1]) > 1
    assert a[1][1:] != b[1][1:]
    assert a[1] != greedy[1]


def test_hot_slot_samples_at_decode(monkeypatch):
    """Decode tokens of a temperature-1 request are not the argmax of the
    decode logits (vocab 512, near-flat random logits)."""
    cfg, p = port_setup()
    eng, seen = spy_engine(monkeypatch, cfg, p, max_batch=1, max_len=64)
    req = eng.submit("hot", max_new_tokens=10, temperature=1.0)
    eng.run_until_done()
    argmax = [int(lg[0].argmax()) for lg in seen["logits"]]
    decoded = req.out_ids[1:]
    assert len(decoded) >= 3
    assert decoded != argmax[:len(decoded)]


# ---------------------------------------------------------------------------
# 3. greedy parity with the JAX engine: MoE and hybrid
# ---------------------------------------------------------------------------

SHORT = ("alpha", "geo", "sat img")     # 6, 4 and 8 tokens: bucket 8


@pytest.mark.parametrize("arch,layers", [("mixtral-8x22b", 2),
                                         ("llama4-maverick-400b-a17b", 4),
                                         ("hymba-1.5b", 2)])
def test_greedy_out_ids_match_jax_engine(arch, layers):
    kw = dict(vocab_size=512, dtype="float32", n_layers=layers)
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jeng = JaxServingEngine(jcfg, jp, max_batch=2, max_len=32)
    jreqs = [jeng.submit(q, max_new_tokens=6) for q in SHORT]
    jeng.run_until_done()
    teng = ServingEngine(tcfg, tp, max_batch=2, max_len=32, device="cpu")
    treqs = [teng.submit(q, max_new_tokens=6) for q in SHORT]
    teng.run_until_done()
    assert max(len(r.prompt_ids) for r in treqs) == 8
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert teng.steps == jeng.steps
