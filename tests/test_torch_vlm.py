"""The port's vision-language family (llava-next-34b: a dense decoder that
takes projected image patches before the text) against the JAX package.

Reduced llava (2 layers, d 64, 4 q heads over 2 KV heads, 4 patches) with
the JAX weights brought across and seeded noise on every norm gain: at
fp32 the prefill with patches (logits and every cache leaf within 1e-4 of
``repro.models.prefill_step``) and three greedy decode steps with equal
tokens; a right-padded text prefill (the engine's dense path); the loss
with patches and every gradient leaf within 3e-5; the bf16 prefill within
3e-2; the engine's greedy tokens equal to the JAX engine's. Then the
repair of the reference's ``pos`` with patches and ``true_lens``, the
layout round trip, every leaf's sharding spec at full width, checkpoints
across the two packages, the training loop and the launchers.
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
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import param_axes, param_shapes, params_from_numpy
from repro_torch.configs import alloc_cache, get_config
from repro_torch.configs.base import reference_fields
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import weight_bytes
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine
from repro_torch.training import AdamWConfig, TokenStream, TrainLoop
from test_torch_encdec import (BF16, F32_MODEL, MESH1, MESH2, TABLES,
                               as_batches, assert_every_leaf_spec_equals_jax,
                               assert_layout_round_trip,
                               assert_loss_and_grads_match,
                               assert_prefill_and_decode_match, f32,
                               jax_abstract, jax_checkpoint_restores_in_port,
                               jax_pair, port_checkpoint_restores_in_jax, rand,
                               tokens)

ARCH = "llava-next-34b"


def test_config_fields_equal_jax():
    cfg = get_config(ARCH)
    assert reference_fields(cfg) == dataclasses.asdict(jax_get_config(ARCH))
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.n_frontend_tokens) == (
        "vlm", 60, 7168, 56, 8, 128, 2880)
    assert cfg.param_count() == jax_get_config(ARCH).param_count()
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    assert round(n / 1e6, 1) == 34440.3
    assert round(weight_bytes(cfg) / 1e9, 2) == 68.88


def test_cache_has_the_dense_layout():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    c = alloc_cache(cfg, 3, 24, torch.device("cpu"))
    assert {k: tuple(t.shape) for k, t in c.items()} == {
        "pos": (3,), "k": (2, 3, 24, 32), "v": (2, 3, 24, 32)}


@pytest.fixture(scope="module")
def pair():
    return jax_pair(ARCH)


def vlm_batch(cfg, B, T, P, seed):
    return {"tokens": tokens(cfg, B, T, seed=seed),
            "patches": rand((B, P, cfg.d_model), seed=seed + 1)}


def test_prefill_with_patches_and_decode_match_jax(pair):
    """4 patches + 7 text tokens (a ring of 24), then 3 greedy steps."""
    jcfg, tcfg, jp, tp = pair
    tc = assert_prefill_and_decode_match(
        jcfg, tcfg, jp, tp, vlm_batch(tcfg, 2, 7, 4, seed=3), max_len=24)
    assert tc["pos"].tolist() == [14, 14]


def test_prefill_with_patches_without_max_len(pair):
    """Without max_len the ring holds patches + text slots."""
    jcfg, tcfg, jp, tp = pair
    tc = assert_prefill_and_decode_match(
        jcfg, tcfg, jp, tp, vlm_batch(tcfg, 1, 5, 4, seed=4), max_len=None,
        steps=1)
    assert tc["k"].shape[2] == 9


def test_right_padded_text_prefill_matches_jax(pair):
    """The engine's route: text only, right-padded, with true_lens."""
    jcfg, tcfg, jp, tp = pair
    assert_prefill_and_decode_match(
        jcfg, tcfg, jp, tp, {"tokens": tokens(tcfg, 2, 8, seed=5)}, max_len=24,
        true_lens=[8, 5])


def test_loss_with_patches_and_every_gradient_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    b = vlm_batch(tcfg, 2, 9, 4, seed=6)
    batch = {"tokens": b["tokens"][:, :-1], "targets": b["tokens"][:, 1:],
             "patches": b["patches"]}
    assert_loss_and_grads_match(jcfg, tcfg, jp, tp, batch)


def test_bf16_prefill_with_patches_close_to_jax():
    jcfg, tcfg, jp, tp = jax_pair(ARCH, dtype="bfloat16", seed=7)
    jb, tb = as_batches(vlm_batch(tcfg, 2, 8, 4, seed=8), "bfloat16")
    jc, jl = jmodel.prefill_step(jcfg, jp, jb, max_len=24)
    tc, tl = tmodel.prefill_step(tcfg, tp, tb, max_len=24)
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)
    np.testing.assert_allclose(f32(tc["k"]), f32(jc["k"]), **BF16)


def test_fp32_patches_are_cast_to_a_bf16_models_dtype():
    """A deviation: the port casts fp32 patches to the model dtype before
    patch_proj, so a bf16 model's prefill is bit for bit that of the
    patches cast by the caller, and its ring stays bf16. The reference
    promotes the whole stream, and so its ring, to fp32."""
    jcfg, tcfg, jp, tp = jax_pair(ARCH, dtype="bfloat16", seed=7)
    b = vlm_batch(tcfg, 2, 6, 4, seed=11)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    c32, l32 = tmodel.prefill_step(tcfg, tp, tb, max_len=24)
    c16, l16 = tmodel.prefill_step(
        tcfg, tp, dict(tb, patches=tb["patches"].bfloat16()), max_len=24)
    assert torch.equal(l32, l16)
    for k in ("k", "v"):
        assert c32[k].dtype == torch.bfloat16 and torch.equal(c32[k], c16[k])
    jc, _ = jmodel.prefill_step(jcfg, jp, {k: jnp.asarray(v) for k, v in b.items()},
                                max_len=24)
    assert jc["k"].dtype == jnp.float32


def test_patch_pos_repair(pair):
    """With patches and true_lens, the port's decode position counts the
    patches: after a right-padded prefill the next decode step equals the
    exact prefill of one more token within 1e-4. The reference sets pos to
    true_lens alone (repro/models/model.py:368): its next step ropes the
    token at the text's length and writes it over a patch's ring slot, and
    misses by far more."""
    jcfg, tcfg, jp, tp = pair
    P, T, lens = 4, 7, [7, 5]
    b = vlm_batch(tcfg, 2, T + 1, P, seed=9)
    toks, nxt = b["tokens"][:, :T].copy(), np.zeros((2, 1), np.int32)
    for r, n in enumerate(lens):
        nxt[r, 0] = b["tokens"][r, n]
        toks[r, n:] = 0                       # right padding
    jb, tb = as_batches({"tokens": toks, "patches": b["patches"]})
    tc, _ = tmodel.prefill_step(tcfg, tp, tb, max_len=24,
                                true_lens=torch.tensor(lens, dtype=torch.int32))
    assert tc["pos"].tolist() == [P + n for n in lens]
    got, _ = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
    jc, _ = jmodel.prefill_step(jcfg, jp, jb, max_len=24,
                                true_lens=jnp.asarray(lens, jnp.int32))
    assert np.asarray(jc["pos"]).tolist() == lens
    jgot, _ = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
    jerr = 0.0
    for r, n in enumerate(lens):
        exact = {"tokens": b["tokens"][r:r + 1, :n + 1],
                 "patches": b["patches"][r:r + 1]}
        _, want = tmodel.prefill_step(tcfg, tp, as_batches(exact)[1], max_len=24)
        np.testing.assert_allclose(f32(got[r]), f32(want[0]), **F32_MODEL)
        jerr = max(jerr, float(np.abs(f32(jgot[r]) - f32(want[0])).max()))
    # the reference's fault, recorded: its step misses the exact prefill
    assert jerr > 100 * F32_MODEL["atol"], jerr


def test_engine_greedy_out_ids_match_jax_engine():
    """Text prompts through both engines (no patches: the dense path)."""
    kw = dict(vocab_size=512, dtype="float32")
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), **kw)
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = ("alpha", "geo", "sat img")
    jeng = JaxServingEngine(jcfg, jp, max_batch=2, max_len=32)
    jreqs = [jeng.submit(q, max_new_tokens=6) for q in prompts]
    jeng.run_until_done()
    teng = ServingEngine(tcfg, tp, max_batch=2, max_len=32, device="cpu")
    treqs = [teng.submit(q, max_new_tokens=6) for q in prompts]
    teng.run_until_done()
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert teng.steps == jeng.steps


def test_layout_round_trip():
    tp = assert_layout_round_trip(*[dataclasses.replace(c.reduced(), dtype="bfloat16")
                                    for c in (jax_get_config(ARCH), get_config(ARCH))])
    assert "enc" not in tp and tuple(tp["patch_proj"].shape) == (64, 64)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_param_axes_and_shapes_equal_jax(reduced):
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    shapes, axes = jax_abstract(jcfg)
    assert param_axes(tcfg) == axes
    assert param_shapes(tcfg) == shapes
    assert axes["patch_proj"] == ("embed", "act_embed")


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
def test_every_leaf_spec_equals_jax(mesh, table):
    assert_every_leaf_spec_equals_jax(ARCH, mesh, table)


def test_jax_train_loop_checkpoint_restores_in_port(tmp_path):
    jax_checkpoint_restores_in_port(ARCH, tmp_path)


def test_port_train_loop_checkpoint_restores_in_jax(tmp_path, monkeypatch):
    port_checkpoint_restores_in_jax(ARCH, tmp_path, monkeypatch)


def test_train_loop_takes_patches_in_the_model_dtype():
    cfg = get_config(ARCH).reduced()
    p = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    ts = TokenStream(cfg, batch=2, seq=16, seed=0)
    loop = TrainLoop(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                     p, iter(ts.next_batch, None))
    seen = []
    step = loop.step_fn

    def spy(params, opt, batch):
        seen.append({k: (v.dtype, tuple(v.shape)) for k, v in batch.items()})
        return step(params, opt, batch)
    loop.step_fn = spy
    loop.run(2)
    assert all(np.isfinite(loop.history)) and len(loop.history) == 2
    assert seen[0]["patches"] == (torch.bfloat16, (2, 4, cfg.d_model))
    assert seen[0]["targets"][1] == (2, 16)


def test_launchers_run_reduced_on_cpu(tmp_path, capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                 "3", "--max-new", "3"])
    assert "'finished': 3" in capsys.readouterr().out
    loop = ttrain.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "16", "--ckpt-dir",
                        str(tmp_path)])
    assert loop.step_idx == 2 and loop.ckpt.available_steps() == [2]
