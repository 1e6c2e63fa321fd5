"""The port's dense model against the JAX model on the same weights.

``dcache-agent-150m.reduced()`` with the JAX-initialised weights brought
across by ``params_from_numpy``. At fp32 the two agree to 1e-4 (sums in
another order). The port's attention kernels keep the softmax weights in
fp32 where the XLA path rounds them to bf16 before P.V, so the bf16 case
allows 3e-2 on logits of magnitude ~0.5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.models import model as jmodel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import single_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as tmodel

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)


def configs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               dtype=dtype, **kw)
    return jcfg, tcfg


def weights(jcfg, tcfg, seed=0):
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    np_tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(np_tree, tcfg, device="cpu")


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def fp32_pair():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def test_forward_hidden_matches_jax(fp32_pair):
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 2, 24)
    jh, _, _ = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                              is_train=False)
    th, _ = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                           is_train=False)
    np.testing.assert_allclose(f32(th), f32(jh), **F32)


@pytest.mark.parametrize("with_true_lens", [False, True])
def test_prefill_logits_and_cache_match_jax(fp32_pair, with_true_lens):
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 3, 16, seed=2)
    lens = np.asarray([16, 9, 3], np.int32)
    jkw = {"true_lens": jnp.asarray(lens)} if with_true_lens else {}
    tkw = {"true_lens": torch.from_numpy(lens)} if with_true_lens else {}
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 max_len=40, **jkw)
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=40, **tkw)
    assert tl.shape == (3, 1, tcfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("max_len", [40, 12])
def test_decode_steps_match_jax(fp32_pair, max_len):
    """Per-step decode logits over 6 steps; max_len 12 wraps the ring."""
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 2, 8, seed=3)
    lens = np.asarray([8, 5], np.int32)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 max_len=max_len, true_lens=jnp.asarray(lens))
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=max_len, true_lens=torch.from_numpy(lens))
    jdec = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(6):
        jl, jc = jdec(jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **F32)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_matches_forward(fp32_pair):
    """Prefill(S) + decode(token S) equals forward over S+1 tokens."""
    _, tcfg, _, tp = fp32_pair
    B, S = 2, 12
    toks = torch.from_numpy(tokens(tcfg, B, S + 1, seed=4))
    h, _ = tmodel.forward(tcfg, tp, {"tokens": toks}, is_train=False)
    ref1 = tmodel._unembed(tcfg, tp, h[:, S - 1:S])
    cache, logits = tmodel.prefill_step(tcfg, tp, {"tokens": toks[:, :S]},
                                        max_len=S + 2)
    np.testing.assert_allclose(f32(logits), f32(ref1), atol=2e-3, rtol=2e-3)
    ref2 = tmodel._unembed(tcfg, tp, h[:, S:S + 1])
    logits2, _ = tmodel.decode_step(tcfg, tp, toks[:, S:S + 1], cache)
    np.testing.assert_allclose(f32(logits2), f32(ref2), atol=2e-3, rtol=2e-3)


def test_vocab_padding_masked(fp32_pair):
    _, tcfg, _, tp = fp32_pair
    assert tcfg.vocab_size == 257 and tcfg.padded_vocab == 512
    _, logits = tmodel.prefill_step(tcfg, tp,
                                    {"tokens": torch.from_numpy(tokens(tcfg, 2, 16))})
    assert (logits[..., tcfg.vocab_size:] < -1e29).all()
    assert torch.isfinite(logits[..., :tcfg.vocab_size]).all()


def test_bf16_prefill_and_decode_close_to_jax():
    jcfg, tcfg = configs("bfloat16")
    jp, tp = weights(jcfg, tcfg, seed=5)
    assert tp["embed"].dtype == torch.bfloat16
    toks = tokens(tcfg, 2, 16, seed=6)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=24)
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=24)
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jl, _ = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
    tl, _ = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_unported_features_raise():
    """What is still unported raises: placing onto a mesh of more than one
    device. (remat="dots" is ported: tests/test_torch_remat.py.)"""
    for multi_pod in (False, True):
        with pytest.raises(NotImplementedError, match="one device"):
            single_device(make_production_mesh(multi_pod=multi_pod))


def test_kv_quant_builds():
    """The int8 KV cache is ported: kv_quant builds, and its cache is int8."""
    _, tcfg = configs(kv_quant=True)
    p = tmodel.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    cache, logits = tmodel.prefill_step(
        tcfg, p, {"tokens": torch.from_numpy(tokens(tcfg, 1, 8))}, max_len=16)
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    assert torch.isfinite(logits[..., :tcfg.vocab_size]).all()
