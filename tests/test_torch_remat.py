"""remat="dots" (JAX's ``dots_with_no_batch_dims_saveable``) against the
JAX package, and its policy counted in the backward.

The loss and every gradient leaf of the reduced dense, MoE, hybrid and
encoder-decoder configs with ``remat="dots"`` on both sides equal JAX's at
fp32 within 3e-5 (ROADMAP's gradient tolerance), on the JAX weights with
every norm gain noised (``test_torch_encdec.jax_pair``). The policy test
counts the products the backward runs (a ``TorchDispatchMode``): without
remat it runs only the gradients' products; under "block" it also re-runs
the decoder layers' forward products (those the backward needs: the
non-reentrant checkpoint stops after the last tensor it must rebuild, so a
layer's final product may not run again); under "dots" it re-runs the same
batched products (``bmm``: attention, the experts, the MoE dispatch) and
no ``mm``/``addmm`` (the projections, the router), whose outputs were kept.
"""
import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from test_torch_encdec import assert_loss_and_grads_match, jax_pair, rand, tokens

CASES = {"dense": ("dcache-agent-150m", 4, 16), "moe": ("mixtral-8x22b", 2, 16),
         "hybrid": ("hymba-1.5b", 2, 16), "encdec": ("seamless-m4t-large-v2", 2, 12)}
aten = torch.ops.aten
PRODUCTS = {aten.mm.default: "mm", aten.addmm.default: "addmm",
            aten.bmm.default: "bmm"}


def batch_of(cfg, B, S, seed=1):
    toks = tokens(cfg, B, S + 1, seed=seed)
    batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
    if cfg.is_encdec:
        batch["frames"] = rand((B, 8, cfg.d_model), seed=seed + 1)
    return batch


@pytest.mark.parametrize("case", list(CASES))
def test_dots_loss_and_every_gradient_match_jax(case):
    arch, B, S = CASES[case]
    jcfg, tcfg, jp, tp = jax_pair(arch, remat="dots")
    assert jcfg.remat == tcfg.remat == "dots"
    assert_loss_and_grads_match(jcfg, tcfg, jp, tp, batch_of(tcfg, B, S))


class CountProducts(TorchDispatchMode):
    """Counts the matrix products that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.n[PRODUCTS[func]] += 1
        return func(*args, **(kwargs or {}))


def _setup(arch, remat):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=512,
                              dtype="float32", remat=remat)
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch_of(cfg, 2, 16).items()}
    return cfg, p, tb


def backward_products(arch, remat):
    cfg, p, tb = _setup(arch, remat)
    leaves = [t.requires_grad_() for t in torch.utils._pytree.tree_leaves(p)]
    total, _ = tmodel.loss_fn(cfg, p, tb)
    with CountProducts() as c:
        total.backward()
    assert all(t.grad is not None for t in leaves)
    return c.n


def layer_forward_products(arch):
    """The products of the decoder layers' forward: what "block" re-runs."""
    cfg, p, tb = _setup(arch, "none")
    x = tmodel._embed_tokens(cfg, p, tb)
    with CountProducts() as c:
        for lp in p["layers"]:
            x, _, _ = tmodel._attn_layer(cfg, lp, x, is_train=True,
                                         collect_cache=False, cache_len=0)
    return c.n


@pytest.mark.parametrize("arch", ["dcache-agent-150m", "mixtral-8x22b",
                                  "hymba-1.5b"])
def test_dots_policy_recomputes_no_projection(arch):
    none, block, dots = (backward_products(arch, r) for r in ("none", "block", "dots"))
    layers = layer_forward_products(arch)
    assert layers["mm"] > 0 and layers["bmm"] > 0
    for op in ("mm", "bmm"):   # block re-runs them (at most the layers' count)
        assert none[op] < block[op] <= none[op] + layers[op], (op, none, block, layers)
    assert dots["mm"] == none["mm"] and dots["addmm"] == none["addmm"], (none, dots)
    assert dots["bmm"] == block["bmm"], (block, dots)


def test_dots_policy_decisions():
    pol = tmodel._dots_policy
    assert pol(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert pol(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert pol(None, op) == CheckpointPolicy.PREFER_RECOMPUTE

