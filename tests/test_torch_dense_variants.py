"""The dense variants against the JAX model: granite-3-2b, phi3-mini-3.8b,
qwen1.5-32b (QKV bias) and qwen3-4b (qk_norm), reduced, at fp32, on the
same numpy weights (``bridge.params_from_numpy``).

The mirrors of tests/test_models_smoke.py's ``test_arch_smoke_prefill_decode``
(prefill and 3 decode steps, here against JAX's logits within 1e-4, the
tolerance of tests/test_torch_model.py), ``test_decode_matches_forward`` and
``test_vocab_padding_masked``; the loss and every gradient leaf against
``jax.value_and_grad(loss_fn)`` within 3e-5 (tests/test_torch_training.py).
JAX initialises qwen1.5's biases and qwen3's q/k norm gains to constants,
which would test nothing: both get seeded noise before either side sees
them. Last, the attention wrappers' refusal of a head dim that is not built.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.models import model as jmodel
from repro_torch.bridge import param_shapes, params_from_numpy, to_jax_layout
from repro_torch.configs import get_config
from repro_torch.configs.base import reference_fields
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import model as tmodel
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import loss_and_grads

IDS = ["granite-3-2b", "phi3-mini-3.8b", "qwen1.5-32b", "qwen3-4b"]
F32_MODEL = dict(atol=1e-4, rtol=1e-4)
F32_GRAD = dict(atol=3e-5, rtol=3e-5)
# leaves JAX initialises to a constant, and the noise they get here
NOISY = {"bq": (0.0, 0.5), "bk": (0.0, 0.5), "bv": (0.0, 0.5),
         "q_norm": (1.0, 0.3), "k_norm": (1.0, 0.3)}


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=IDS)
def pair(request):
    """(jax cfg, port cfg, JAX params, port params) of the reduced config at
    fp32, with seeded noise on the constant-initialised attention leaves."""
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0), dtype=jnp.float32),
                                 jcfg))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(11)
    attn = tree["dec"]["attn"]
    for name, (mean, std) in NOISY.items():
        if name in attn:
            attn[name] = (mean + rng.normal(0, std, attn[name].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("arch", IDS)
def test_config_fields_equal_jax(arch):
    assert reference_fields(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))


def test_granite_is_plain_dense_with_padded_vocab():
    cfg = get_config("granite-3-2b")
    assert (cfg.head_dim_, cfg.n_heads // cfg.n_kv_heads) == (64, 4)
    assert cfg.tie_embeddings and not (cfg.qkv_bias or cfg.qk_norm)
    assert (cfg.vocab_size, cfg.padded_vocab) == (49155, 49408)


def test_qkv_bias_leaves_zero_at_init_and_in_the_jax_layout():
    cfg = get_config("qwen1.5-32b").reduced()
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    hq, kv, hd = cfg.n_attn_heads, cfg.n_kv_heads, cfg.head_dim_
    for lp in p["layers"]:
        a = lp["attn"]
        assert {n: tuple(a[n].shape) for n in ("bq", "bk", "bv")} == {
            "bq": (hq * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
        assert all(not a[n].any() for n in ("bq", "bk", "bv"))
    stacked = to_jax_layout(p, cfg)["dec"]["attn"]
    assert {n: tuple(stacked[n].shape) for n in ("bq", "bk", "bv")} == {
        n: param_shapes(cfg)["dec"]["attn"][n] for n in ("bq", "bk", "bv")}


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
    for k in ("k", "v"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_MODEL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        assert np.isfinite(f32(tl)).all()
        np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
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
    jgt = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu",
                            dtype=torch.float32)
    for lp in grads["layers"]:   # the noisy leaves carry gradient
        for name in NOISY:
            if name in lp["attn"]:
                assert lp["attn"][name].abs().max() > 0, name
    pairs = list(zip(tree_leaves(grads), tree_leaves(jgt)))
    assert len(pairs) == len(tree_leaves(tp))
    for a, b in pairs:
        np.testing.assert_allclose(f32(a), f32(b), **F32_GRAD)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-4b"])
def test_decode_matches_forward(arch):
    """Prefill(S) + decode(token S) equals forward over S + 1 tokens (the
    mirror of tests/test_models_smoke.py::test_decode_matches_forward, on
    the port's own random weights)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
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


def test_vocab_padding_masked():
    cfg = get_config("granite-3-2b").reduced()   # vocab 257 -> padded 512
    assert cfg.padded_vocab == 512
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    _, logits = tmodel.prefill_step(cfg, p, {"tokens": torch.from_numpy(
        tokens(cfg, 2, 16))})
    assert (f32(logits)[..., cfg.vocab_size:] < -1e29).all()


# ---------------------------------------------------------------------------
# head dims: the wrappers take exactly the built ones on the card
# ---------------------------------------------------------------------------

class NoLibrary(Exception):
    pass


@pytest.fixture
def card_route(monkeypatch):
    """The wrappers' card route without a card: every input takes the
    kernel's checks, and reaching the library raises NoLibrary."""
    monkeypatch.setattr(_build, "use_plain", lambda name, *t: False)

    def no_library(*a, **k):
        raise NoLibrary

    monkeypatch.setattr(_build, "load_library", no_library)


def attention_calls(d):
    q = torch.zeros((1, 8, 16, d), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 16, d), dtype=torch.bfloat16)
    codes = torch.zeros((1, 2, 16, d), dtype=torch.int8)
    sc = torch.ones((1, 2, 16), dtype=torch.bfloat16)
    pos = torch.zeros(1, dtype=torch.int32)
    return {"flash_attention": lambda: tops.flash_attention(q, k, k),
            "decode_attention": lambda: tops.decode_attention(
                q[:, :, 0].contiguous(), k, k, pos),
            "decode_attention_int8": lambda: tops.decode_attention_int8(
                q[:, :, 0].contiguous(), codes, codes, sc, sc, pos)}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "decode_attention_int8"])
def test_wrappers_refuse_unbuilt_head_dim(card_route, name):
    with pytest.raises(ValueError, match="head dim 80"):
        attention_calls(80)[name]()
    assert HEAD_DIMS == (16, 32, 64, 96, 128)
    for d in HEAD_DIMS:   # accepted: the call gets as far as the library
        with pytest.raises(NoLibrary):
            attention_calls(d)[name]()
