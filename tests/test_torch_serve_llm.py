"""The train-then-serve driver (``repro_torch.launch.serve_llm``, the twin
of examples/serve_llm.py) on the CPU, and the serving engine's no_grad.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch import serve_llm
from repro_torch.models.model import init_model
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamWConfig, TokenStream
from repro_torch.training.optimizer import tree_leaves, tree_map


def test_smoke_config_is_the_examples():
    cfg = serve_llm.build_config(smoke=True)
    assert (cfg.vocab_size, cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim_) == (512, 4, 128, 512, 4, 2, 16)
    full = serve_llm.build_config(smoke=False)
    assert full.name == "dcache-agent-150m" and full.head_dim_ == 64


def test_smoke_trains_then_serves_on_cpu():
    cfg = serve_llm.build_config(smoke=True)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    stream = TokenStream(cfg, batch=8, seq=64, seed=0)
    loop, metrics = serve_llm.train(
        cfg, params, iter(stream.next_batch, None), 12,
        AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=12))
    assert len(loop.history) == len(metrics) == 12
    assert [m["loss"] for m in metrics] == loop.history
    assert all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0 for m in metrics)
    assert np.mean(loop.history[-3:]) < np.mean(loop.history[:3]) - 0.2
    eng, reqs = serve_llm.serve(cfg, loop.params, serve_llm.PROMPTS[:3],
                                device="cpu")
    assert all(r.done and len(r.out_ids) == 12 for r in reqs)
    text = serve_llm.decide(eng)
    assert isinstance(text, str) and len(text) > 0


def test_main_smoke_cpu(capsys):
    serve_llm.main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--requests", "2"])
    out = capsys.readouterr().out
    assert "trained 3 steps" in out and "served 2 requests" in out
    assert "TorchLLM cache-decision completion" in out


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_llm.main(["--smoke", "--steps", "1"])


def test_engine_decodes_under_no_grad():
    """Params that still require grad decode the same tokens as plain ones,
    and the cache the engine keeps carries no graph."""
    cfg = dataclasses.replace(serve_llm.build_config(smoke=True), dtype="float32")
    plain = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    grad = tree_map(lambda t: t.clone().requires_grad_(), plain)
    out = []
    for params in (plain, grad):
        eng = ServingEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=5) for p in serve_llm.PROMPTS[:3]]
        eng.run_until_done()
        out.append([r.out_ids for r in reqs])
        assert all(t.grad_fn is None and not t.requires_grad
                   for t in eng.cache.values())
    assert out[0] == out[1]
    assert all(t.requires_grad for t in tree_leaves(grad))
