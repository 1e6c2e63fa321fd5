"""The training launcher, the fault-tolerance example and qwen3-4b's
qk_norm: TrainLoop surviving injected failures from checkpoints on disk
(the mirror of tests/test_fault_tolerance.py's slow test, small enough for
the default lane), ``launch.train`` with ``--resume``, ``launch.train_tiny``,
and reduced qwen3-4b against the JAX model at fp32, at the tolerances of
tests/test_torch_model.py (1e-4) and tests/test_torch_training.py (3e-5).
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.distributed import Checkpointer, FailureInjector, HeartbeatMonitor
from repro_torch.launch import train, train_tiny
from repro_torch.models import model as tmodel
from repro_torch.models.model import init_model
from repro_torch.training import AdamWConfig, TokenStream, TrainLoop
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import loss_and_grads

F32_MODEL = dict(atol=1e-4, rtol=1e-4)
F32_GRAD = dict(atol=3e-5, rtol=3e-5)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# fault tolerance from disk, the launchers
# ---------------------------------------------------------------------------

def test_train_loop_survives_failures_and_resumes(tmp_path):
    cfg = get_config("dcache-agent-150m").reduced()
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    stream = TokenStream(cfg, batch=4, seq=24, seed=0)
    mon = HeartbeatMonitor()
    ck = Checkpointer(str(tmp_path), keep=2)
    loop = TrainLoop(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20),
                     params, iter(stream.next_batch, None),
                     checkpointer=ck, ckpt_every=4, monitor=mon,
                     failure_injector=FailureInjector([5, 9]))
    loop.run(12)
    assert len(mon.failures) == 2
    assert all(f["restored"] for f in mon.failures)
    assert loop.step_idx == 12
    assert ck.available_steps() == [8, 12]

    # cold restart resumes from the last checkpoint
    loop2 = TrainLoop(cfg, AdamWConfig(), params,
                      iter(stream.next_batch, None), checkpointer=ck)
    assert loop2.restore_if_available()
    assert loop2.step_idx == 12
    for a, b in zip(tree_leaves(loop2.params), tree_leaves(loop.params)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(tree_leaves(loop2.opt_state), tree_leaves(loop.opt_state)):
        assert torch.equal(a, b)


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    base = ["--device", "cpu", "--preset", "smoke", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(base + ["--steps", "3"])
    assert first.step_idx == 3 and len(first.history) == 3
    assert first.ckpt.available_steps() == [2, 3]
    second = train.main(base + ["--steps", "5", "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert second.step_idx == 5 and len(second.history) == 2
    loop, data = train.build(train.parse_args(base + ["--steps", "5", "--resume"]))
    data.close()
    assert loop.step_idx == 5
    for a, b in zip(tree_leaves(loop.params), tree_leaves(second.params)):
        assert torch.equal(a, b)


def test_launch_train_tiny_recovers_and_restarts():
    out = train_tiny.main(["--device", "cpu", "--steps", "12"])
    assert out["fail_at"] == [4, 6]
    assert [f["restored"] for f in out["failures"]] == [True, True]
    assert out["loop"].step_idx == 12 and out["kept"] == [11, 12]
    assert out["restarted"].step_idx == 12
    assert out["loop"].cfg.name == "qwen3-4b-smoke" and out["loop"].cfg.qk_norm
    assert all(np.isfinite(out["loop"].history))


# ---------------------------------------------------------------------------
# qwen3-4b (qk_norm) against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen3():
    """Reduced qwen3-4b at fp32 on JAX's weights, with seeded noise on the
    q/k norm gains (initialised to ones) so that the gains carry weight."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-4b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen3-4b").reduced(), dtype="float32")
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0), dtype=jnp.float32),
                                 jcfg))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(7)
    for k in ("q_norm", "k_norm"):
        a = tree["dec"]["attn"][k]
        tree["dec"]["attn"][k] = (1 + rng.normal(0, 0.3, a.shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_qwen3_params_carry_qk_norm(qwen3):
    _, tcfg, _, tp = qwen3
    assert tcfg.qk_norm and tcfg.head_dim_ == 16
    for lp in tp["layers"]:
        assert set(lp["attn"]) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
        assert lp["attn"]["q_norm"].shape == (16,)
    fresh = init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(fresh["layers"][0]["attn"]["k_norm"], torch.ones(16))


def test_qwen3_prefill_and_decode_match_jax(qwen3):
    jcfg, tcfg, jp, tp = qwen3
    toks = tokens(tcfg, 2, 8, seed=3)
    lens = np.asarray([8, 5], np.int32)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 max_len=16, true_lens=jnp.asarray(lens))
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=16, true_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
    for k in ("k", "v"):
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32_MODEL)
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(4):
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **F32_MODEL)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def test_qwen3_loss_and_every_gradient_match_jax(qwen3):
    jcfg, tcfg, jp, tp = qwen3
    toks = tokens(tcfg, 2, 17, seed=4)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "targets": torch.from_numpy(toks[:, 1:].copy())}
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    grads, m = loss_and_grads(tcfg, tp, tb)
    np.testing.assert_allclose(f32(m["loss"]), f32(jm["loss"]), **F32_GRAD)
    jgt = params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, device="cpu",
                            dtype=torch.float32)
    for l in range(tcfg.n_layers):
        for k in ("q_norm", "k_norm"):
            assert grads["layers"][l]["attn"][k].abs().max() > 0
    for a, b in zip(tree_leaves(grads), tree_leaves(jgt)):
        np.testing.assert_allclose(f32(a), f32(b), **F32_GRAD)


def test_qwen3_decode_matches_forward(qwen3):
    """Prefill(S) + decode(token S) equals forward over S+1 tokens (the
    mirror of tests/test_models_smoke.py::test_decode_matches_forward)."""
    _, tcfg, _, tp = qwen3
    B, S = 2, 12
    toks = torch.from_numpy(tokens(tcfg, B, S + 1, seed=5))
    h, _ = tmodel.forward(tcfg, tp, {"tokens": toks}, is_train=False)
    ref1 = tmodel._unembed(tcfg, tp, h[:, S - 1:S])
    cache, logits = tmodel.prefill_step(tcfg, tp, {"tokens": toks[:, :S]},
                                        max_len=S + 2)
    np.testing.assert_allclose(f32(logits), f32(ref1), atol=2e-3, rtol=2e-3)
    ref2 = tmodel._unembed(tcfg, tp, h[:, S:S + 1])
    logits2, _ = tmodel.decode_step(tcfg, tp, toks[:, S:S + 1], cache)
    np.testing.assert_allclose(f32(logits2), f32(ref2), atol=2e-3, rtol=2e-3)
