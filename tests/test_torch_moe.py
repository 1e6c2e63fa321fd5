"""The port's MoE family against the JAX package: mixtral-8x22b (8 experts,
top-2, every layer MoE, window) and llama4-maverick-400b-a17b (128
experts, top-1, a shared expert, MoE every other layer, chunked attention).

Reduced, at fp32, on the same numpy weights (``bridge.params_from_numpy``):
``_routing``'s dispatch, combine and logits within 1e-6 (a case that drops
tokens, a case of two groups, bf16 logits with crafted ties, where the
experts chosen must be ``lax.top_k``'s); ``moe`` within 1e-5; prefill and
3 decode steps within 1e-4 (llama4 at 4 layers: two super-layers, so the
dense/MoE regrouping runs); the loss, the aux loss and every gradient leaf
within 3e-5 (tests/test_torch_training.py's tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.models import mlp_moe as jmoe
from repro.models import model as jmodel
from repro_torch.bridge import params_from_numpy, to_jax_layout
from repro_torch.configs import get_config
from repro_torch.configs.base import reference_fields
from repro_torch.models import mlp_moe as tmoe
from repro_torch.models import model as tmodel
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import loss_and_grads

MIXTRAL, LLAMA4 = "mixtral-8x22b", "llama4-maverick-400b-a17b"
IDS = [MIXTRAL, LLAMA4]
# llama4 at 4 layers: two super-layers of (dense, MoE)
LAYERS = {MIXTRAL: 2, LLAMA4: 4}
ROUTE = dict(atol=1e-6, rtol=1e-6)
MOE = dict(atol=1e-5, rtol=1e-5)
F32_MODEL = dict(atol=1e-4, rtol=1e-4)
F32_GRAD = dict(atol=3e-5, rtol=3e-5)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def configs(arch, dtype="float32", **kw):
    kw = dict(dict(n_layers=LAYERS[arch], dtype=dtype), **kw)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def jax_tree(jcfg, seed=0):
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    return jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module", params=IDS)
def pair(request):
    jcfg, tcfg = configs(request.param)
    jp, tree = jax_tree(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def moe_layer(jp, tp, tcfg, s=0):
    """Super-layer s's MoE weights: JAX's (jnp) and the port's."""
    k = tcfg.moe.interleave
    return (jax.tree.map(lambda a: a[s], jp["dec"]["moe"]),
            tp["layers"][s * k + k - 1]["moe"])


def grouped(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", IDS)
def test_config_fields_equal_jax(arch):
    assert reference_fields(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))


@pytest.mark.parametrize("arch", IDS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_counts_equal_jax(arch, reduced):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.moe_layer_mask() == jcfg.moe_layer_mask()


def test_moe_capacity_mirrors_reference():
    """tests/test_perf_features.py::test_moe_decode_dropless, and the same
    numbers as JAX's ``moe_capacity`` at every group size the engine
    makes."""
    cfg = get_config(MIXTRAL)
    assert tmoe.moe_capacity(cfg, 2) == 2 * cfg.moe.top_k
    assert tmoe.moe_capacity(cfg, 8) == 8 * cfg.moe.top_k
    assert tmoe.moe_capacity(cfg, 1024) < 1024 * cfg.moe.top_k
    for arch in IDS:
        for t in (1, 4, 8, 32, 33, 64, 512, 1024):
            assert tmoe.moe_capacity(get_config(arch), t) == \
                jmoe.moe_capacity(jax_get_config(arch), t)


def test_layers_alternate_dense_and_moe():
    _, tcfg = configs(LLAMA4)
    p = tmodel.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert [("moe" in lp, "mlp" in lp) for lp in p["layers"]] == \
        [(False, True), (True, False)] * 2
    moe = p["layers"][1]["moe"]
    E, D, F = tcfg.moe.n_experts, tcfg.d_model, tcfg.d_ff
    assert {n: tuple(t.shape) for n, t in moe.items()} == {
        "router": (D, E), "we_gate": (E, D, F), "we_up": (E, D, F),
        "we_down": (E, F, D), "ws_gate": (D, F), "ws_up": (D, F),
        "ws_down": (F, D)}
    _, mcfg = configs(MIXTRAL)
    pm = tmodel.init_model(mcfg, torch.Generator().manual_seed(0), "cpu")
    assert all("moe" in lp and "mlp" not in lp for lp in pm["layers"])


def test_experts_drawn_one_at_a_time_at_the_leaf_scale():
    """Each expert is drawn with the whole leaf's fan_in (D, or F for
    we_down): truncated normal in +-2 std, std 1/sqrt(fan_in)."""
    cfg = dataclasses.replace(get_config(LLAMA4).reduced(), dtype="float32",
                              d_model=256, d_ff=512)
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    for name, fan_in, scale in (("we_gate", 256, 1.0), ("we_up", 256, 1.0),
                                ("we_down", 512, 1 / np.sqrt(cfg.n_layers))):
        w = p[name]
        std = scale / np.sqrt(fan_in)
        assert w.dtype == torch.float32
        assert float(w.abs().max()) <= 2 * std + 1e-7
        # a truncated unit normal has std 0.8796
        np.testing.assert_allclose(float(w.std()), 0.8796 * std, rtol=0.02)
        assert not torch.equal(w[0], w[1])     # experts drawn independently


# ---------------------------------------------------------------------------
# routing and the MoE block
# ---------------------------------------------------------------------------

def routing_both(jmp, tmp, jcfg, tcfg, xg):
    jd, jc, jl = jmoe._routing(jmp, jcfg, jnp.asarray(xg))
    td, tc, tl = tmoe._routing(tmp, tcfg, torch.from_numpy(xg))
    for a, b in ((td, jd), (tc, jc), (tl, jl)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(f32(a), f32(b), **ROUTE)
    return f32(jd)


def test_routing_drops_tokens_like_jax(pair):
    """One group of 512 tokens: capacity 1.25 * T * K / E. The tokens share
    an offset, so the router favours the same experts for most of them and
    some expert overflows: some (token, k) is dropped."""
    jcfg, tcfg, jp, tp = pair
    jmp, tmp = moe_layer(jp, tp, tcfg)
    xg = grouped((1, 512, tcfg.d_model), seed=1) \
        + grouped((1, 1, tcfg.d_model), seed=9, scale=2.0)
    d = routing_both(jmp, tmp, jcfg, tcfg, xg)
    kept = d.sum(axis=(2, 3))                          # per token, <= K
    assert (kept < tcfg.moe.top_k).any(), "no token was dropped"
    assert d.shape[-1] == tmoe.moe_capacity(tcfg, 512)


def test_routing_two_groups(pair):
    """B*S = 2048 tokens fold into two groups of GROUP_TOKENS."""
    jcfg, tcfg, jp, tp = pair
    jmp, tmp = moe_layer(jp, tp, tcfg)
    x = grouped((2, 1024, tcfg.d_model), seed=2)
    xg = x.reshape(2, tmoe.GROUP_TOKENS, tcfg.d_model)
    routing_both(jmp, tmp, jcfg, tcfg, xg)
    out_j = jmoe.moe(jmp, jcfg, jnp.asarray(x))
    out_t = tmoe.moe(tmp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(f32(out_t), f32(out_j), **MOE)


@pytest.mark.parametrize("arch", IDS)
def test_routing_bf16_ties_pick_jax_experts(arch):
    """bf16 router logits with exact ties (duplicated router columns, and
    tokens that are multiples of one another): the experts chosen, and so
    dispatch and combine, equal ``lax.top_k``'s, the lower index first."""
    jcfg, tcfg = configs(arch, dtype="bfloat16")
    E, D = tcfg.moe.n_experts, tcfg.d_model
    rng = np.random.default_rng(5)
    router = rng.normal(0, D ** -0.5, (D, E)).astype(np.float32)
    # experts in pairs of equal columns: every logit ties with its pair's
    for e in range(1, E, 2):
        router[:, e] = router[:, e - 1]
    x = rng.normal(0, 1, (1, 64, D)).astype(np.float32)
    tmp = {"router": torch.from_numpy(router).to(torch.bfloat16)}
    jmp = {"router": jnp.asarray(router, jnp.bfloat16)}
    jd, jc, jl = jmoe._routing(jmp, jcfg, jnp.asarray(x, jnp.bfloat16))
    td, tc, tl = tmoe._routing(tmp, tcfg, torch.from_numpy(x).to(torch.bfloat16))
    jlog = np.asarray(jl)
    assert (jlog[..., 0::2] == jlog[..., 1::2]).all()   # the ties are there
    np.testing.assert_array_equal(f32(tl), jlog)
    _, jidx = jax.lax.top_k(jl, tcfg.moe.top_k)
    _, tidx = tmoe._top_k(tl, tcfg.moe.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert (tidx[..., 0] % 2 == 0).all()     # the lower of a tied pair first
    np.testing.assert_array_equal(f32(td), np.asarray(jd))
    np.testing.assert_allclose(f32(tc), np.asarray(jc), **ROUTE)


def test_moe_block_matches_jax(pair):
    """The block at a prefill's shape (B 2, S 16: one group, drops) and a
    decode step's (B 4, S 1: dropless)."""
    jcfg, tcfg, jp, tp = pair
    jmp, tmp = moe_layer(jp, tp, tcfg)
    for shape, seed in (((2, 16, tcfg.d_model), 3), ((4, 1, tcfg.d_model), 4)):
        x = grouped(shape, seed)
        np.testing.assert_allclose(
            f32(tmoe.moe(tmp, tcfg, torch.from_numpy(x))),
            f32(jmoe.moe(jmp, jcfg, jnp.asarray(x))), **MOE)
        np.testing.assert_allclose(
            f32(tmoe.moe_aux_loss(tmp, tcfg, torch.from_numpy(x))),
            f32(jmoe.moe_aux_loss(jmp, jcfg, jnp.asarray(x))), **MOE)


# ---------------------------------------------------------------------------
# the model: serving steps, loss and gradients
# ---------------------------------------------------------------------------

def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_prefill_and_decode_match_jax(pair):
    """tests/test_models_smoke.py::test_arch_smoke_prefill_decode (B 2,
    S 16, max_len 24, 3 decode steps on the argmax token), held to JAX."""
    jcfg, tcfg, jp, tp = pair
    toks = tokens(tcfg, 2, 16, seed=3)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=24)
    assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
    assert sorted(tc) == sorted(jc)
    for k in ("k", "v"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_MODEL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        assert np.isfinite(f32(tl)).all()
        np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def test_loss_aux_and_every_gradient_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    toks = tokens(tcfg, 2, 17, seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "targets": torch.from_numpy(toks[:, 1:].copy())}
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    grads, m = loss_and_grads(tcfg, tp, tb)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(f32(m[k]), f32(jm[k]), **F32_GRAD)
    # tests/test_models_smoke.py::test_moe_aux_loss_positive (~1 balanced)
    assert float(m["aux_loss"]) > 0.5
    total, _ = tmodel.loss_fn(tcfg, tp, tb)
    np.testing.assert_allclose(f32(total), f32(jtotal), **F32_GRAD)
    jgt = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu",
                            dtype=torch.float32)
    for lp in grads["layers"]:     # the router learns through the aux loss
        if "moe" in lp:
            assert lp["moe"]["router"].abs().max() > 0
    pairs = list(zip(tree_leaves(grads), tree_leaves(jgt)))
    assert len(pairs) == len(tree_leaves(tp))
    for a, b in pairs:
        np.testing.assert_allclose(f32(a), f32(b), **F32_GRAD)


def test_jax_layout_round_trip(pair):
    """``to_jax_layout`` regroups the layers into JAX's ``dec/moe`` (one per
    super-layer) and ``dec/mlp`` (the dense layers in order), equal to the
    JAX tree leaf for leaf."""
    jcfg, tcfg, jp, tp = pair
    back = to_jax_layout(tp, tcfg)
    want = jax.tree.map(np.asarray, jp)
    assert set(back["dec"]) == set(want["dec"])
    assert ("mlp" in back["dec"]) == (tcfg.moe.interleave > 1)
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(f32, back))[0]
    flat_j = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_t] == \
        [jax.tree_util.keystr(p) for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
