"""The serving engine's captured decode step: on a CUDA device an engine
whose model ``captures_decode`` replays ``decode_step`` as one CUDA graph.

Which configurations capture (read from the layer types alone), the
in-place ``pos`` of ``decode_step`` that a replay relies on (every cache
tensor stays the object it was), and the CPU's engine, which never
captures. On the card (``card``), a captured engine's greedy tokens and
logits against an eager ``decode_step`` loop over 64 steps, through
``chip_smoke.captured_against_eager``.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ALL_IDS, alloc_cache, get_config
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import captures_decode

ROOT = Path(__file__).resolve().parents[1]
# every registered configuration: a decoder with no expert layer (dense, or
# vlm served as dense) captures; MoE, ssm, hybrid and encdec do not
CAPTURES = {"mixtral-8x22b": False, "llama4-maverick-400b-a17b": False,
            "granite-3-2b": True, "phi3-mini-3.8b": True, "qwen1.5-32b": True,
            "qwen3-4b": True, "seamless-m4t-large-v2": False, "rwkv6-7b": False,
            "llava-next-34b": True, "hymba-1.5b": False, "dcache-agent-150m": True}
FAMILIES = {"dense": "granite-3-2b", "moe": "mixtral-8x22b", "ssm": "rwkv6-7b",
            "hybrid": "hymba-1.5b", "encdec": "seamless-m4t-large-v2",
            "vlm": "llava-next-34b"}


def test_every_registered_config_is_listed():
    assert set(CAPTURES) == set(ALL_IDS)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16-ring", "int8-ring"])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_capture_follows_the_layer_types(arch, kv_quant):
    cfg = dataclasses.replace(get_config(arch), kv_quant=kv_quant)
    assert captures_decode(cfg) is CAPTURES[arch]
    assert captures_decode(cfg.reduced()) is CAPTURES[arch]
    # the rule reads the structure, not the name
    assert captures_decode(dataclasses.replace(cfg, name="renamed")) is CAPTURES[arch]


def test_variants_of_a_dense_decoder_capture():
    assert get_config("qwen3-4b").qk_norm and captures_decode(get_config("qwen3-4b"))
    dense = get_config("granite-3-2b")
    for kw in (dict(sliding_window=64), dict(attn_chunk=64), dict(qk_norm=True)):
        assert captures_decode(dataclasses.replace(dense, **kw)), kw
    moe = get_config("mixtral-8x22b")
    assert not captures_decode(dataclasses.replace(moe, family="dense"))


@pytest.mark.parametrize("arch", FAMILIES.values(), ids=list(FAMILIES))
def test_decode_step_advances_pos_in_place(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = alloc_cache(cfg, 2, 16, torch.device("cpu"))
    cache["pos"].copy_(torch.tensor([3, 7], dtype=torch.int32))
    objects = dict(cache)
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    for want in ([4, 8], [5, 9]):
        logits, out = tmodel.decode_step(cfg, params, toks, cache)
        assert out is cache and set(cache) == set(objects)
        assert all(cache[k] is v for k, v in objects.items())
        assert cache["pos"].dtype == torch.int32 and cache["pos"].tolist() == want
        assert torch.isfinite(logits[..., :cfg.vocab_size]).all()


@pytest.mark.parametrize("arch", ["dcache-agent-150m", "mixtral-8x22b"])
def test_an_engine_on_the_cpu_never_captures(monkeypatch, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=512,
                              dtype="float32")
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = engine_mod.decode_step

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(engine_mod, "decode_step", counted)
    eng = ServingEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=6) for p in ("alpha", "geo", "three")]
    eng.run_until_done()
    assert all(r.done for r in reqs)
    assert eng.steps > 2 and len(calls) == eng.steps
    assert eng.replays == 0 and eng._graph is None and eng._tokens is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the chip)")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captured_engine_replays_the_eager_tokens(card, dtype):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                              vocab_size=512, dtype=dtype)
    params = tmodel.init_model(cfg, torch.Generator(device=card).manual_seed(0), card)
    prompts = ("alpha", "a much longer prompt about satellites", "geo", "four")
    steps, replays, worst, _ = chip_smoke.captured_against_eager(
        cfg, params, prompts, 4, 256, 65, 3e-2)
    assert steps >= 64 and replays == steps - 1 and worst <= 3e-2
