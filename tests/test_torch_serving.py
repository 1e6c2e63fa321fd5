"""The port's serving engine: greedy parity with the JAX engine, and the
engine properties of tests/test_serving.py on the port alone.

Reduced ``dcache-agent-150m`` at fp32 with vocab 512 (the byte tokenizer
needs >= 258); the JAX-initialised weights come across through
``params_from_numpy``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.agent import TorchLLM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as engine_mod
from test_torch_rwkv import noisy_jax_params

PROMPTS = ("alpha", "a much longer prompt about satellites", "geo")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               vocab_size=512, dtype="float32")
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               vocab_size=512, dtype="float32")
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def engine(setup, max_batch=3, max_len=96):
    _, tcfg, _, tp = setup
    return ServingEngine(tcfg, tp, max_batch=max_batch, max_len=max_len,
                         device="cpu")


def test_greedy_out_ids_match_jax_engine(setup):
    jcfg, _, jp, _ = setup
    jeng = JaxServingEngine(jcfg, jp, max_batch=3, max_len=96)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in PROMPTS]
    jeng.run_until_done()
    teng = engine(setup)
    treqs = [teng.submit(p, max_new_tokens=6) for p in PROMPTS]
    teng.run_until_done()
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert teng.steps == jeng.steps
    s = teng.stats()
    assert s["finished"] == 3 and s["throughput_tok_s"] > 0


def test_more_requests_than_slots(setup):
    eng = engine(setup, max_batch=2)
    reqs = [eng.submit(f"req {i}", max_new_tokens=4) for i in range(5)]
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.prefills == 5


def test_greedy_determinism_across_batching(setup):
    eng1 = engine(setup, max_batch=1)
    r_alone = eng1.submit("determinism test prompt", max_new_tokens=5)
    eng1.run_until_done()
    eng2 = engine(setup, max_batch=3)
    r_b = eng2.submit("determinism test prompt", max_new_tokens=5)
    eng2.submit("other request one", max_new_tokens=5)
    eng2.submit("yet another", max_new_tokens=5)
    eng2.run_until_done()
    assert r_alone.out_ids == r_b.out_ids


def test_padding_invariance(setup, monkeypatch):
    eng = engine(setup, max_batch=1)
    r1 = eng.submit("abcdefgh", max_new_tokens=5)   # 9 ids -> bucket 16
    eng.run_until_done()
    monkeypatch.setattr(engine_mod, "_bucket", lambda n, cap: n)
    eng2 = engine(setup, max_batch=1)
    r2 = eng2.submit("abcdefgh", max_new_tokens=5)
    eng2.run_until_done()
    assert r1.out_ids == r2.out_ids


def test_max_len_cap_terminates(setup):
    eng = engine(setup, max_batch=1, max_len=24)
    r = eng.submit("x" * 10, max_new_tokens=500)
    eng.run_until_done()
    assert r.done
    assert len(r.out_ids) < 30


def test_torch_llm_complete_returns_text(setup):
    llm = TorchLLM(engine(setup), max_new_tokens=4)
    out = llm.complete("Detect airplanes in this area")
    assert isinstance(out, str)
    assert llm.engine.finished[-1].done


# ---------------------------------------------------------------------------
# rwkv6 (ssm): recurrent state, prompts at their exact length
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_setup():
    """Reduced rwkv6-7b at fp32, vocab 512, with seeded noise on the
    zero-initialised ``u``, ``w0`` and ``mu_*`` leaves of the JAX tree."""
    jcfg = dataclasses.replace(jax_get_config("rwkv6-7b").reduced(),
                               vocab_size=512, dtype="float32")
    tcfg = dataclasses.replace(get_config("rwkv6-7b").reduced(),
                               vocab_size=512, dtype="float32")
    jp, tree = noisy_jax_params(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("max_batch", [3, 2])
def test_ssm_greedy_out_ids_match_jax_engine(ssm_setup, max_batch):
    """Three prompts of three lengths; with 2 slots the third request
    reuses a freed slot, so its installed state must replace the old one."""
    jcfg, tcfg, jp, tp = ssm_setup
    jeng = JaxServingEngine(jcfg, jp, max_batch=max_batch, max_len=96)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in PROMPTS]
    jeng.run_until_done()
    teng = ServingEngine(tcfg, tp, max_batch=max_batch, max_len=96, device="cpu")
    treqs = [teng.submit(p, max_new_tokens=6) for p in PROMPTS]
    teng.run_until_done()
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert teng.steps == jeng.steps


@pytest.mark.parametrize("arch", ["rwkv6-7b", "dcache-agent-150m"])
def test_prompt_length_at_prefill(setup, ssm_setup, monkeypatch, arch):
    """An ssm prompt is prefilled at its exact length (pad tokens would
    enter the recurrent state); a dense one is right-padded to its bucket."""
    _, tcfg, _, tp = ssm_setup if arch == "rwkv6-7b" else setup
    seen = []
    real = engine_mod.prefill_step

    def spy(cfg, params, batch, **kw):
        seen.append((batch["tokens"].shape[1], int(kw["true_lens"][0])))
        return real(cfg, params, batch, **kw)

    monkeypatch.setattr(engine_mod, "prefill_step", spy)
    eng = ServingEngine(tcfg, tp, max_batch=2, max_len=96, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=2) for p in PROMPTS]
    eng.run_until_done()
    lens = [len(r.prompt_ids) for r in reqs]
    assert [n for _, n in seen] == lens
    expect = lens if arch == "rwkv6-7b" else [engine_mod._bucket(n, 96) for n in lens]
    assert [s for s, _ in seen] == expect
    assert expect != lens or arch == "rwkv6-7b"


# ---------------------------------------------------------------------------
# the launcher: the MoE and hybrid archs, and the memory check before drawing
# ---------------------------------------------------------------------------

def test_launcher_refuses_weights_over_free_memory():
    from repro_torch.launch.serve import check_fits, weight_bytes

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=12)
    need = weight_bytes(cfg)
    assert need == 2 * 30_451_390_464          # 60.9 GB of bf16 weights
    check_fits(cfg, need)
    with pytest.raises(MemoryError, match=r"60\.90 GB .* 60\.00 GB free"):
        check_fits(cfg, 60_000_000_000)
    full = get_config("llama4-maverick-400b-a17b")
    with pytest.raises(MemoryError, match="795.39 GB"):
        check_fits(full, 85_000_000_000)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-maverick-400b-a17b",
                                  "hymba-1.5b"])
def test_launcher_serves_new_archs_on_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.count(" -> ") == 3 and "'finished': 3" in out
