"""The port's encoder-decoder family (seamless-m4t-large-v2) against the
JAX package.

Reduced seamless (2 encoder and 2 decoder layers, d 64, MHA over 4 heads)
with the JAX weights brought across, every norm gain given seeded noise
(JAX initialises them to ones, which would hide a gain applied in the wrong
place): at fp32 the prefill logits and every cache leaf, ``cross_k`` and
``cross_v`` included, within 1e-4 of ``repro.models.prefill_step`` on
right-padded prompts; three greedy decode steps within 1e-4 with equal
tokens; the loss and every gradient leaf within 3e-5; the bf16 prefill
within 3e-2. Then the layout round trip, every leaf's sharding spec at full
width, checkpoints across the two packages, the serving route (the
encoder's attention on the flash wrapper unmasked, cross-attention on the
decode wrapper, launch counts by the rule chip_smoke.py holds on the card),
the engine's refusal, the training loop and the launchers.

The helpers here serve ``tests/test_torch_vlm.py`` too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cache_specs
from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.models import model as jmodel
from repro_torch.bridge import (from_jax_layout, param_axes, param_shapes,
                                params_from_numpy, to_jax_layout)
from repro_torch.configs import alloc_cache, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamWConfig, TokenStream, TrainLoop
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import loss_and_grads
from test_torch_checkpoint import (jax_checkpoint_restores_in_port,
                                   port_checkpoint_restores_in_jax)
from test_torch_sharding import (MESH1, MESH2, TABLES,
                                 assert_every_leaf_spec_equals_jax,
                                 jax_abstract)

ARCH = "seamless-m4t-large-v2"
F32_MODEL = dict(atol=1e-4, rtol=1e-4)
F32_GRAD = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rand(shape, seed, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def jax_pair(arch, dtype="float32", seed=0, **kw):
    """(jax cfg, port cfg, JAX params, port params) of the reduced ``arch``:
    the JAX weights, every norm gain with seeded noise, brought across."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **kw)
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    rng = np.random.default_rng(seed + 40)

    def noisy(path, a):
        a = np.asarray(a)
        if "norm" in str(path[-1].key):
            return (1.0 + rng.normal(0, 0.3, a.shape)).astype(a.dtype)
        return a
    tree = jax.tree_util.tree_map_with_path(noisy, jp)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"))


def as_batches(batch, dtype="float32"):
    """A numpy batch as JAX and as torch arrays; float entries in the model
    dtype on both sides."""
    jb, tb = {}, {}
    for k, v in batch.items():
        if v.dtype == np.float32:
            jb[k] = jnp.asarray(v, jnp.dtype(dtype))
            tb[k] = torch.from_numpy(v).to(getattr(torch, dtype))
        else:
            jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(np.ascontiguousarray(v))
    return jb, tb


def assert_prefill_and_decode_match(jcfg, tcfg, jp, tp, batch, max_len,
                                    true_lens=None, steps=3, tol=F32_MODEL):
    """Prefill logits and every cache leaf, then ``steps`` greedy decode
    steps (logits, tokens and every cache leaf), port against JAX."""
    jb, tb = as_batches(batch, tcfg.dtype)
    jkw, tkw = {}, {}
    if true_lens is not None:
        jkw["true_lens"] = jnp.asarray(true_lens, jnp.int32)
        tkw["true_lens"] = torch.tensor(true_lens, dtype=torch.int32)
    jc, jl = jmodel.prefill_step(jcfg, jp, jb, max_len=max_len, **jkw)
    tc, tl = tmodel.prefill_step(tcfg, tp, tb, max_len=max_len, **tkw)
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **tol, err_msg=k)
    nxt = np.argmax(f32(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(steps):
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **tol)
        nxt = np.argmax(f32(jl)[:, -1], -1).astype(np.int32)[:, None]
        assert (np.argmax(f32(tl)[:, -1], -1) == nxt[:, 0]).all()
        for k in jc:
            np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **tol, err_msg=k)
    return tc


def assert_loss_and_grads_match(jcfg, tcfg, jp, tp, batch):
    jb, tb = as_batches(batch, tcfg.dtype)
    (_, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    grads, m = loss_and_grads(tcfg, tp, tb)
    np.testing.assert_allclose(f32(m["loss"]), f32(jm["loss"]), **F32_GRAD)
    np.testing.assert_allclose(f32(m["accuracy"]), f32(jm["accuracy"]), atol=0)
    jgt = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu",
                            dtype=torch.float32)
    pairs = list(zip(tree_leaves(grads), tree_leaves(jgt)))
    assert len(pairs) == len(tree_leaves(tp))
    for a, b in pairs:
        assert a.abs().max() > 0
        np.testing.assert_allclose(f32(a), f32(b), **F32_GRAD)


def assert_layout_round_trip(jcfg, tcfg, seed=0):
    """params_from_numpy then to_jax_layout gives the JAX tree back
    exactly, and from_jax_layout undoes to_jax_layout with views."""
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    back = to_jax_layout(tp, tcfg)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == tcfg.torch_dtype
        np.testing.assert_array_equal(f32(a), np.asarray(b, np.float32))
    again = from_jax_layout(back, tcfg)
    for a, b in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(a, b)
    return tp


class Recorder:
    """Counts the attention and norm wrappers' calls on the CPU (where
    they run their plain versions and count no launch), with each
    attention call's mask arguments."""

    def __init__(self, monkeypatch):
        self.flash, self.decode, self.rmsnorm = [], [], 0
        f, d, r = ops.flash_attention, ops.decode_attention, ops.rmsnorm

        def flash(q, k, v, **kw):
            self.flash.append((q.shape[2], k.shape[2], kw))
            return f(q, k, v, **kw)

        def decode(q, k, v, pos, **kw):
            self.decode.append((k.shape[2], pos.tolist(), kw))
            return d(q, k, v, pos, **kw)

        def norm(*a, **kw):
            self.rmsnorm += 1
            return r(*a, **kw)
        monkeypatch.setattr(ops, "flash_attention", flash)
        monkeypatch.setattr(ops, "decode_attention", decode)
        monkeypatch.setattr(ops, "rmsnorm", norm)

    def reset(self):
        self.flash, self.decode, self.rmsnorm = [], [], 0


# ---------------------------------------------------------------------------
# config and cache
# ---------------------------------------------------------------------------

def test_config_fields_equal_jax():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model,
            cfg.head_dim_, cfg.act, cfg.padded_vocab) == (
        "encdec", 24, 24, 1024, 64, "gelu", 256256)
    assert cfg.param_count() == jax_get_config(ARCH).param_count()
    # the leaves' sum: param_count leaves out frame_proj and a few norms
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    assert round(n / 1e6, 1) == 1633.3


def test_cache_leaves_equal_cache_specs():
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
        tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
        want = {k: (s.shape, str(s.dtype))
                for k, s in cache_specs(jcfg, 3, 24).items()}
        got = {k: (tuple(t.shape), str(t.dtype)[6:])
               for k, t in alloc_cache(tcfg, 3, 24, torch.device("cpu")).items()}
        assert got == want
        assert got["cross_k"][0] == (2, 3, 12, 64)


# ---------------------------------------------------------------------------
# numerics against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    return jax_pair(ARCH)


def encdec_batch(cfg, B, T, S_enc, seed):
    return {"tokens": tokens(cfg, B, T, seed=seed),
            "frames": rand((B, S_enc, cfg.d_model), seed=seed + 1)}


def test_prefill_and_decode_match_jax(pair):
    """Right-padded prompts (true lengths 7 and 4 of 7), 10 frames, a ring
    of 24 slots, then 3 greedy decode steps."""
    jcfg, tcfg, jp, tp = pair
    tc = assert_prefill_and_decode_match(
        jcfg, tcfg, jp, tp, encdec_batch(tcfg, 2, 7, 10, seed=3), max_len=24,
        true_lens=[7, 4])
    assert tuple(tc["cross_k"].shape) == (2, 2, 10, 64)
    assert tc["pos"].tolist() == [10, 7]


def test_prefill_without_max_len_counts_the_frames(pair):
    """Without max_len the reference's ring holds tokens + frames slots."""
    jcfg, tcfg, jp, tp = pair
    tc = assert_prefill_and_decode_match(
        jcfg, tcfg, jp, tp, encdec_batch(tcfg, 1, 5, 6, seed=4), max_len=None,
        steps=1)
    assert tc["k"].shape[2] == 11 and tc["pos"].tolist() == [6]


def test_loss_and_every_gradient_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    b = encdec_batch(tcfg, 2, 9, 8, seed=5)
    batch = {"tokens": b["tokens"][:, :-1], "targets": b["tokens"][:, 1:],
             "frames": b["frames"]}
    assert_loss_and_grads_match(jcfg, tcfg, jp, tp, batch)


def test_bf16_prefill_close_to_jax():
    jcfg, tcfg, jp, tp = jax_pair(ARCH, dtype="bfloat16", seed=6)
    assert tp["enc"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    jb, tb = as_batches(encdec_batch(tcfg, 2, 8, 12, seed=7), "bfloat16")
    jc, jl = jmodel.prefill_step(jcfg, jp, jb, max_len=24)
    tc, tl = tmodel.prefill_step(tcfg, tp, tb, max_len=24)
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)
    for k in ("cross_k", "cross_v"):
        assert tc[k].dtype == torch.bfloat16
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **BF16)


def test_fp32_frames_are_cast_to_a_bf16_models_dtype():
    """A deviation: the port casts fp32 frames to the model dtype before
    frame_proj, so a bf16 model's prefill is bit for bit that of the frames
    cast by the caller, and every cache leaf stays bf16. The reference
    raises on fp32 frames in a bf16 model (its decoder scan's carry turns
    fp32 through cross-attention on the fp32 memory)."""
    jcfg, tcfg, jp, tp = jax_pair(ARCH, dtype="bfloat16", seed=6)
    b = encdec_batch(tcfg, 2, 6, 8, seed=11)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    c32, l32 = tmodel.prefill_step(tcfg, tp, tb, max_len=24)
    c16, l16 = tmodel.prefill_step(
        tcfg, tp, dict(tb, frames=tb["frames"].bfloat16()), max_len=24)
    assert torch.equal(l32, l16)
    for k in ("k", "v", "cross_k", "cross_v"):
        assert c32[k].dtype == torch.bfloat16 and torch.equal(c32[k], c16[k])
    with pytest.raises(TypeError, match="carry"):
        jmodel.prefill_step(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()},
                            max_len=24)


def test_decode_matches_prefill_of_one_more_token():
    """On the port's own weights: prefill(S tokens) + decode(token S)
    equals the last logits of prefill(S + 1 tokens), same frames."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(2), "cpu")
    _, tb = as_batches(encdec_batch(cfg, 2, 9, 6, seed=8))
    full = dict(tb)
    short = dict(tb, tokens=tb["tokens"][:, :8])
    cache, _ = tmodel.prefill_step(cfg, p, short, max_len=16)
    got, _ = tmodel.decode_step(cfg, p, tb["tokens"][:, 8:9], cache)
    _, want = tmodel.prefill_step(cfg, p, full, max_len=16)
    np.testing.assert_allclose(f32(got), f32(want), **F32_MODEL)


# ---------------------------------------------------------------------------
# the serving route, layouts, specs, checkpoints
# ---------------------------------------------------------------------------

def test_serving_route_and_launch_rule(monkeypatch):
    """A prefill runs the encoder's Le attention calls on the flash wrapper
    unmasked (causal=False, no window, no chunk) and the decoder's L
    causal; rmsnorm 2*Le+1 + 3*L+1 times. A decode step runs 2*L decode
    calls (L on the self ring, L on the encoder's S_enc slots with pos =
    S_enc - 1 and no window or chunk) and rmsnorm 3*L+1 times."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                              n_layers=3)
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    L, Le, S_enc = 3, cfg.n_encoder_layers, 10
    rec = Recorder(monkeypatch)
    _, tb = as_batches(encdec_batch(cfg, 2, 6, S_enc, seed=9))
    cache, logits = tmodel.prefill_step(cfg, p, tb, max_len=32)
    assert [kw["causal"] for _, _, kw in rec.flash] == [False] * Le + [True] * L
    assert all(kw["window"] is None and kw["chunk"] is None
               for _, _, kw in rec.flash)
    assert [s for s, _, _ in rec.flash] == [S_enc] * Le + [6] * L
    assert rec.rmsnorm == 2 * Le + 1 + 3 * L + 1 and not rec.decode
    rec.reset()
    tmodel.decode_step(cfg, p, logits[:, -1].argmax(-1, keepdim=True).int(),
                       cache)
    assert rec.rmsnorm == 3 * L + 1 and not rec.flash
    assert [c for c, _, _ in rec.decode] == [32, S_enc] * L
    assert all(pos == [S_enc - 1] * 2 and kw == {}
               for c, pos, kw in rec.decode if c == S_enc)


def test_layout_round_trip():
    tp = assert_layout_round_trip(*[dataclasses.replace(c.reduced(), dtype="bfloat16")
                                    for c in (jax_get_config(ARCH), get_config(ARCH))])
    assert sorted(tp["enc"]) == ["final_norm", "layers"]
    assert len(tp["enc"]["layers"]) == 2
    assert sorted(tp["layers"][0]) == ["attn", "cross", "mlp", "norm1", "norm2",
                                       "norm3"]
    assert sorted(tp["layers"][0]["cross"]) == ["wk", "wo", "wq", "wv"]
    assert tuple(tp["frame_proj"].shape) == (64, 64)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_axes_and_shapes_equal_jax(reduced):
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    shapes, axes = jax_abstract(jcfg)
    assert param_axes(tcfg) == axes
    assert param_shapes(tcfg) == shapes
    assert axes["frame_proj"] == ("embed", "act_embed")


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
def test_every_leaf_spec_equals_jax(mesh, table):
    assert_every_leaf_spec_equals_jax(ARCH, mesh, table)


def test_jax_train_loop_checkpoint_restores_in_port(tmp_path):
    jax_checkpoint_restores_in_port(ARCH, tmp_path)


def test_port_train_loop_checkpoint_restores_in_jax(tmp_path, monkeypatch):
    port_checkpoint_restores_in_jax(ARCH, tmp_path, monkeypatch)


def test_engine_refuses_encdec_naming_the_entry_points():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), vocab_size=512)
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prefill_step.*decode_step"):
        ServingEngine(cfg, p, device="cpu")


# ---------------------------------------------------------------------------
# training loop and launchers
# ---------------------------------------------------------------------------

def test_train_loop_takes_frames_in_the_model_dtype():
    cfg = get_config(ARCH).reduced()
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    loop = TrainLoop(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                     p, iter(TokenStream(cfg, batch=2, seq=16, seed=0).next_batch,
                             None))
    seen = []
    step = loop.step_fn

    def spy(params, opt, batch):
        seen.append({k: (v.dtype, v.device.type, tuple(v.shape))
                     for k, v in batch.items()})
        return step(params, opt, batch)
    loop.step_fn = spy
    loop.run(2)
    assert all(np.isfinite(loop.history)) and len(loop.history) == 2
    assert seen[0]["frames"] == (torch.bfloat16, "cpu", (2, 8, cfg.d_model))
    assert seen[0]["tokens"][0] == torch.int32


def test_launchers_run_reduced_on_cpu(tmp_path, capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("+ 256 frames ->") == 2
    loop = ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--ckpt-dir",
                        str(tmp_path)])
    assert loop.step_idx == 2 and loop.ckpt.available_steps() == [2]
