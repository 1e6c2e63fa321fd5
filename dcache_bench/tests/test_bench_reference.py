"""The plain reference agrees with the port's CPU path at a tiny size.

Both run in float32 here, so every served token is the reference's best
to rounding; the expert layer's capacity rule (with the prompt's bucket
pads) is held place for place against the port's dispatch."""
import json

import pytest
import torch

from bench_tiny import make_root
from dcache_bench import harness, judge


def fp32_root(tmp_path):
    root = make_root(tmp_path)
    for name in ("tiny-dense", "tiny-moe"):
        p = root / "dcache_bench" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["torch_dtype"] = "float32"
        p.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("cell", ["tiny-decide", "tiny-react"])
def test_served_tokens_are_the_references_best(tmp_path, monkeypatch, cell):
    root = fp32_root(tmp_path)
    monkeypatch.setitem(harness.load_architecture(root, "decoder").SUPPORTED,
                        "torch_dtype", "float32")
    c = harness.prepare(root, cell)
    sv = harness.serve(c, 11, 3.0, False, "cpu", 0.0)
    sample = judge.sample(sv.finished, 11, 80)
    got = judge.readings(c.ref, c.sizes, sv.params, sample, sv.prompts, c.sizes["max_len"])
    assert got["tokens"] >= 80
    assert got["gap_max"] < 1e-4


def test_reference_tokenizes_as_the_engine(tmp_path):
    c = harness.prepare(make_root(tmp_path), "tiny-decide")
    sv = harness.serve(c, 4, 2.0, False, "cpu", 0.0)
    for r in sv.finished[:10]:
        assert c.ref.tokenize(sv.prompts[r.rid], c.sizes["max_len"]) == r.prompt_ids


@pytest.mark.parametrize("tokens", [100, 128, 2048])
def test_capacity_rule_equals_the_ports(tmp_path, tokens):
    from repro_torch.models import mlp_moe
    from dcache_bench import program

    c = harness.prepare(make_root(tmp_path), "tiny-react")
    sizes = dict(c.sizes, dtype="float32")
    p = c.arch.make_params(sizes, 5, "cpu")["layers"][0]["moe"]
    # correlated tokens, as a prompt's are, so some experts overflow
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(8, sizes["d_model"], generator=g)[torch.randint(0, 8, (tokens,), generator=g)]
         + 0.1 * torch.randn(tokens, sizes["d_model"], generator=g))
    cfg = program.model_config(c.arch.model_fields("t", sizes))
    T = mlp_moe.GROUP_TOKENS if tokens % mlp_moe.GROUP_TOKENS == 0 else tokens
    dispatch, _, _ = mlp_moe._routing(p, cfg, x.reshape(tokens // T, T, -1))
    port = dispatch.sum(-1).reshape(tokens, -1) > 0            # (token, expert) kept
    idx, _, kept = c.ref._route(x, p["router"], sizes, True, c.ref.plain_linear)
    ref = torch.zeros_like(port)
    for k in range(idx.shape[1]):
        ref[torch.arange(tokens)[kept[:, k]], idx[kept[:, k], k]] = True
    assert torch.equal(port, ref)
    assert (~kept).any()                                        # drops happen
