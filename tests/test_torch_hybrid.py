"""The port's hybrid family (hymba-1.5b: attention and Mamba heads in
parallel in every layer) against the JAX package.

``models/mamba.py`` on the same numpy inputs: ``mamba_mix`` at S 128 (two
of JAX's 64-step scan chunks) and at S 100 (one chunk of 100), and
``mamba_step`` from a non-zero state and conv carry, within 1e-5 at fp32.
The zero- and one-initialised leaves (``b_dt``, ``a_log``, ``d_skip``) get
seeded noise so that the decay, dt offset and skip are exercised. Reduced
hymba at fp32: prefill and 3 decode steps within 1e-4, the loss and every
gradient leaf within 3e-5, and prefill + decode equal to ``forward``
(tests/test_models_smoke.py::test_decode_matches_forward for hymba).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import alloc_cache, get_config
from repro_torch.configs.base import reference_fields
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as tmodel
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import loss_and_grads

ARCH = "hymba-1.5b"
SSM = dict(atol=1e-5, rtol=1e-5)
F32_MODEL = dict(atol=1e-4, rtol=1e-4)
F32_GRAD = dict(atol=3e-5, rtol=3e-5)
# leaves JAX initialises to a constant, and the noise they get here
NOISY = {"b_dt": (0.0, 0.5), "a_log": (0.0, 0.5), "d_skip": (1.0, 0.3)}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def configs(dtype="float32", **kw):
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, **kw))


def noisy_tree(jcfg, seed=0):
    """The JAX params with seeded noise on the SSM heads' constant leaves,
    as JAX arrays and as numpy."""
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(30 + seed)
    ssm = tree["dec"]["ssm"]
    for name, (mean, std) in NOISY.items():
        ssm[name] = (mean + rng.normal(0, std, ssm[name].shape)).astype(
            ssm[name].dtype)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = configs()
    jp, tree = noisy_tree(jcfg)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def ssm_layer(jp, tp, l=0):
    return jax.tree.map(lambda a: a[l], jp["dec"]["ssm"]), tp["layers"][l]["ssm"]


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def test_config_fields_equal_jax():
    assert reference_fields(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.n_attn_heads, cfg.n_ssm_heads, cfg.n_kv_heads) == (15, 10, 5)
    assert cfg.param_count() == jax_get_config(ARCH).param_count()


def test_init_mamba_constants():
    _, tcfg = configs()
    p = tmamba.init_mamba(tcfg, torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    H, hd, N = tcfg.n_ssm_heads, tcfg.ssm.head_dim, tcfg.ssm.state_size
    assert not p["b_dt"].any() and not p["a_log"].any()
    assert (p["d_skip"] == 1).all()
    assert tuple(p["conv"].shape) == (tcfg.ssm.conv_width, H * hd)
    assert float(p["conv"].abs().max()) <= 2 * 0.5 / np.sqrt(tcfg.ssm.conv_width)
    assert tuple(p["w_B"].shape) == (tcfg.d_model, H * N)


def test_softplus_has_no_threshold():
    x = np.array([-40.0, -3.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0], np.float32)
    np.testing.assert_allclose(f32(tmamba.softplus(torch.from_numpy(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("S", [128, 100])
def test_mamba_mix_matches_jax(pair, S):
    """S 128 runs JAX's scan in two 64-step chunks, S 100 in one chunk."""
    jcfg, tcfg, jp, tp = pair
    jsp, tsp = ssm_layer(jp, tp, 1)
    H, hd, N = tcfg.n_ssm_heads, tcfg.ssm.head_dim, tcfg.ssm.state_size
    x = rand((2, S, tcfg.d_model), seed=S)
    s0 = rand((2, H, hd, N), seed=S + 1, scale=0.3)
    jo, js, jc = jmamba.mamba_mix(jsp, jcfg, jnp.asarray(x), jnp.asarray(s0))
    to, ts, tc = tmamba.mamba_mix(tsp, tcfg, torch.from_numpy(x),
                                  torch.from_numpy(s0))
    assert ts.dtype == torch.float32
    for a, b in ((to, jo), (ts, js), (tc, jc)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(f32(a), f32(b), **SSM)


def test_mamba_step_matches_jax(pair):
    """Four steps from a non-zero state and conv carry."""
    jcfg, tcfg, jp, tp = pair
    jsp, tsp = ssm_layer(jp, tp, 0)
    H, hd, N = tcfg.n_ssm_heads, tcfg.ssm.head_dim, tcfg.ssm.state_size
    cw = tcfg.ssm.conv_width
    js = ts = None
    for t in range(4):
        x = rand((3, 1, tcfg.d_model), seed=40 + t)
        if t == 0:
            s0 = rand((3, H, hd, N), seed=50, scale=0.3)
            c0 = rand((3, cw - 1, H * hd), seed=51)
            js, jc = jnp.asarray(s0), jnp.asarray(c0)
            ts, tc = torch.from_numpy(s0), torch.from_numpy(c0)
        jo, js, jc = jmamba.mamba_step(jsp, jcfg, jnp.asarray(x), js, jc)
        to, ts, tc = tmamba.mamba_step(tsp, tcfg, torch.from_numpy(x), ts, tc)
        for a, b in ((to, jo), (ts, js), (tc, jc)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(f32(a), f32(b), **SSM)


def test_cache_leaves_and_shapes():
    _, tcfg = configs()
    c = alloc_cache(tcfg, 3, 24, torch.device("cpu"))
    H, hd, N = tcfg.n_ssm_heads, tcfg.ssm.head_dim, tcfg.ssm.state_size
    L, C, cw = tcfg.n_layers, 8, tcfg.ssm.conv_width    # window 8
    assert {k: (tuple(t.shape), t.dtype) for k, t in c.items()} == {
        "pos": ((3,), torch.int32),
        "k": ((L, 3, C, tcfg.n_kv_heads * tcfg.head_dim_), torch.float32),
        "v": ((L, 3, C, tcfg.n_kv_heads * tcfg.head_dim_), torch.float32),
        "ssm_state": ((L, 3, H, hd, N), torch.float32),
        "conv_state": ((L, 3, cw - 1, H * hd), torch.float32)}
    bf = alloc_cache(configs("bfloat16")[1], 1, 24, torch.device("cpu"))
    assert bf["ssm_state"].dtype == torch.float32
    assert bf["conv_state"].dtype == torch.bfloat16


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_prefill_and_decode_match_jax(pair):
    """Prefill (B 2, S 16, past the window of 8) and 3 decode steps."""
    jcfg, tcfg, jp, tp = pair
    toks = tokens(tcfg, 2, 16, seed=3)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=24)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_MODEL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
        for k in ("ssm_state", "conv_state"):
            np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_MODEL)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def test_loss_and_every_gradient_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    toks = tokens(tcfg, 2, 17, seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "targets": torch.from_numpy(toks[:, 1:].copy())}
    (_, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    grads, m = loss_and_grads(tcfg, tp, tb)
    np.testing.assert_allclose(f32(m["loss"]), f32(jm["loss"]), **F32_GRAD)
    assert float(m["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    jgt = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu",
                            dtype=torch.float32)
    for lp in grads["layers"]:     # the SSM heads carry gradient
        assert all(t.abs().max() > 0 for t in lp["ssm"].values())
    pairs = list(zip(tree_leaves(grads), tree_leaves(jgt)))
    assert len(pairs) == len(tree_leaves(tp))
    for a, b in pairs:
        np.testing.assert_allclose(f32(a), f32(b), **F32_GRAD)


def test_decode_matches_forward():
    """Prefill(S) + decode(token S) equals forward over S + 1 tokens, on
    the port's own random weights (the mirror of
    tests/test_models_smoke.py::test_decode_matches_forward)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(tokens(cfg, B, S + 1, seed=5))
    h, _ = tmodel.forward(cfg, p, {"tokens": toks}, is_train=False)
    ref1 = tmodel._unembed(cfg, p, h[:, S - 1:S])
    cache, logits = tmodel.prefill_step(cfg, p, {"tokens": toks[:, :S]},
                                        max_len=S + 2)
    np.testing.assert_allclose(f32(logits), f32(ref1), atol=2e-3, rtol=2e-3)
    ref2 = tmodel._unembed(cfg, p, h[:, S:S + 1])
    logits2, _ = tmodel.decode_step(cfg, p, toks[:, S:S + 1], cache)
    np.testing.assert_allclose(f32(logits2), f32(ref2), atol=2e-3, rtol=2e-3)
