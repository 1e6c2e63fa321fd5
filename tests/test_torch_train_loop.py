"""The port's train step, TrainLoop, data pipeline and fault tolerance,
against the JAX package and as the mirrors of tests/test_training.py and
tests/test_fault_tolerance.py.

Parameters after an AdamW step are held at JAX's own accumulation-test
tolerance (atol 5e-5, rtol 5e-4; tests/test_training.py): the first Adam
step is close to sign(g), so a gradient element near zero that differs by
1e-9 moves its parameter by up to ~lr. Everything before the update (loss,
metrics, moments) is held at 3e-5.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Init, init_model as jax_init_model, unbox
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtrain
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.distributed import (FailureInjector, HeartbeatMonitor,
                                     PreemptionGuard, WorkerFailure)
from repro_torch.models.model import init_model
from repro_torch.training import (AdamWConfig, Prefetcher, TokenStream,
                                  TrainLoop, init_opt_state, make_train_step)
from repro_torch.training.optimizer import tree_leaves, tree_map

F32 = dict(atol=3e-5, rtol=3e-5)
AFTER_STEP = dict(atol=5e-5, rtol=5e-4)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def step_inputs():
    """Reduced dcache-agent-150m at fp32 on JAX's weights, one batch of
    8 x 16 from TokenStream, and the JAX accumulation test's AdamW."""
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               dtype="float32")
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jnp.float32), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    b = jdata.TokenStream(jcfg, batch=8, seq=16, seed=3).next_batch()
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10, grad_clip=1e9)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                jb={k: jnp.asarray(v) for k, v in b.items()},
                tb={k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in b.items()},
                jc=jopt.AdamWConfig(**kw), tc=AdamWConfig(**kw))


def test_grad_accum_matches_full_batch(step_inputs):
    c = step_inputs
    opt = init_opt_state(c["tp"])
    p1, _, m1 = make_train_step(c["tcfg"], c["tc"], accum_steps=1)(c["tp"], opt, c["tb"])
    p2, o2, m2 = make_train_step(c["tcfg"], c["tc"], accum_steps=2)(c["tp"], opt, c["tb"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(f32(a), f32(b), **AFTER_STEP)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-5)
    assert int(o2["step"]) == 1


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(step_inputs, accum):
    c = step_inputs
    jp2, jo2, jm = jtrain.make_train_step(c["jcfg"], c["jc"], accum)(
        c["jp"], jopt.init_opt_state(c["jp"]), c["jb"])
    tp2, to2, tm = make_train_step(c["tcfg"], c["tc"], accum)(
        c["tp"], init_opt_state(c["tp"]), c["tb"])
    assert set(tm) == set(jm) == {"loss", "aux_loss", "accuracy", "lr", "grad_norm"}
    for k in tm:
        np.testing.assert_allclose(f32(tm[k]), f32(jm[k]), **F32)
    want = params_from_numpy(jax.tree.map(np.asarray, jp2), c["tcfg"], device="cpu")
    for a, b in zip(tree_leaves(tp2), tree_leaves(want)):
        np.testing.assert_allclose(f32(a), f32(b), **AFTER_STEP)
    for k in ("mu", "nu"):
        moment = params_from_numpy(jax.tree.map(np.asarray, jo2[k]), c["tcfg"],
                                   device="cpu", dtype=torch.float32)
        for a, b in zip(tree_leaves(to2[k]), tree_leaves(moment)):
            np.testing.assert_allclose(f32(a), f32(b), **F32)
    assert int(to2["step"]) == int(jo2["step"]) == 1


def test_trained_params_are_plain_leaves(step_inputs):
    c = step_inputs
    p, _, _ = make_train_step(c["tcfg"], c["tc"])(
        c["tp"], init_opt_state(c["tp"]), c["tb"])
    assert all(not t.requires_grad and t.is_leaf for t in tree_leaves(p))
    assert tree_map(lambda t: t.dtype, p) == tree_map(lambda t: t.dtype, c["tp"])
    assert all(not t.requires_grad for t in tree_leaves(c["tp"]))


def small_cfg():
    return get_config("dcache-agent-150m").reduced()


def port_params(cfg, seed=0):
    return init_model(cfg, torch.Generator().manual_seed(seed), "cpu")


def test_loss_decreases_over_training():
    """tests/test_training.py's mirror (slow-marked there): 25 bf16 steps on
    JAX's weights and batches, each step's loss within 2e-2 of JAX's
    jitted step."""
    cfg, jcfg = small_cfg(), jax_get_config("dcache-agent-150m").reduced()
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(0),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jopt.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=40)))
    jo, jstream, jhist = jopt.init_opt_state(jp), jdata.TokenStream(
        jcfg, batch=8, seq=32, seed=0), []
    for _ in range(25):
        b = {k: jnp.asarray(v) for k, v in jstream.next_batch().items()}
        jp, jo, m = jstep(jp, jo, b)
        jhist.append(float(m["loss"]))
    stream = TokenStream(cfg, batch=8, seq=32, seed=0)
    loop = TrainLoop(cfg, AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=40),
                     tp, iter(stream.next_batch, None), ckpt_every=0)
    loop.run(25)
    np.testing.assert_allclose(loop.history, jhist, atol=2e-2, rtol=2e-2)
    assert np.mean(loop.history[-5:]) < np.mean(loop.history[:5]) - 0.2
    assert all(t.dtype == torch.bfloat16 and not t.requires_grad
               for t in tree_leaves(loop.params))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rank", [(0, 0), (0, 1), (7, 3)])
def test_token_stream_matches_jax(seed, rank):
    tcfg, jcfg = small_cfg(), jax_get_config("dcache-agent-150m").reduced()
    ts = TokenStream(tcfg, batch=3, seq=20, seed=seed, rank=rank, n_ranks=4)
    js = jdata.TokenStream(jcfg, batch=3, seq=20, seed=seed, rank=rank, n_ranks=4)
    for _ in range(3):
        a, b = ts.next_batch(), js.next_batch()
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_keeps_the_stream_order():
    cfg = small_cfg()
    ref = TokenStream(cfg, batch=2, seq=8, seed=5)
    pf = Prefetcher(TokenStream(cfg, batch=2, seq=8, seed=5), depth=2)
    try:
        for _ in range(5):
            got, want = next(pf), ref.next_batch()
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_array_equal(got["targets"], want["targets"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_keeps_the_order_for_a_slow_consumer():
    """A consumer slower than the queue's 0.2 s put timeout still sees every
    batch in order. The reference's Prefetcher drops the batch of a put
    that times out (a fault the port repairs), so its slow consumer skips
    batches: recorded here."""
    cfg = small_cfg()
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               vocab_size=cfg.vocab_size)
    for make, stream_cls, c in ((Prefetcher, TokenStream, cfg),
                                (jdata.Prefetcher, jdata.TokenStream, jcfg)):
        ref = stream_cls(c, batch=2, seq=8, seed=5)
        want = [ref.next_batch()["tokens"] for _ in range(12)]
        pf = make(stream_cls(c, batch=2, seq=8, seed=5), depth=1)
        try:
            got = []
            for _ in range(3):
                time.sleep(0.5)       # the queue is full: the put times out
                got.append(next(pf)["tokens"])
        finally:
            pf.close()
        in_order = all(np.array_equal(g, w) for g, w in zip(got, want))
        assert not pf._thread.is_alive()
        if make is Prefetcher:
            assert in_order
        else:
            assert not in_order, "the reference's Prefetcher kept the order"
            assert all(any(np.array_equal(g, w) for w in want) for g in got)


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_fault_tolerance.py's mirrors)
# ---------------------------------------------------------------------------

def test_heartbeat_straggler_detection():
    mon = HeartbeatMonitor(straggler_sigma=3.0)
    for i in range(20):
        mon.record_step(i, 0.10 + 0.001 * (i % 3))
    assert not mon.stragglers
    mon.record_step(20, 1.5)
    assert 20 in mon.stragglers
    assert mon.is_straggling(2.0)
    assert not mon.is_straggling(0.11)


def test_failure_injector_fires_once():
    inj = FailureInjector([3])
    inj(2)
    with pytest.raises(WorkerFailure):
        inj(3)
    inj(3)


def test_preemption_guard_checkpoints_once():
    calls = []
    g = PreemptionGuard(lambda: calls.append(1))
    g.notify()
    g.notify()
    assert calls == [1]
    assert g.preempted


def _loop(cfg, **kw):
    stream = TokenStream(cfg, batch=2, seq=16, seed=0)
    return TrainLoop(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20),
                     port_params(cfg), iter(stream.next_batch, None), **kw)


def test_train_loop_retries_an_injected_failure():
    cfg = small_cfg()
    mon = HeartbeatMonitor()
    loop = _loop(cfg, monitor=mon, failure_injector=FailureInjector([1, 2]))
    assert not loop.restore_if_available()          # no checkpointer
    loop.run(3)
    assert loop.step_idx == 3 and len(loop.history) == 3
    assert [f["step"] for f in mon.failures] == [1, 2]
    assert not any(f["restored"] for f in mon.failures)
    assert len(mon.step_times) == 3


class MemoryCheckpointer:
    """Keeps the latest saved tree in memory (the checkpointer's duck type)."""

    def __init__(self):
        self.saved = []

    def save(self, step, tree):
        self.saved.append(tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree))

    def restore_latest(self, like):
        return self.saved[-1] if self.saved else None


def test_train_loop_restores_from_a_checkpointer():
    cfg = small_cfg()
    mon = HeartbeatMonitor()
    ck = MemoryCheckpointer()
    loop = _loop(cfg, checkpointer=ck, ckpt_every=2, monitor=mon,
                 failure_injector=FailureInjector([3]))
    loop.run(4)
    assert [f["restored"] for f in mon.failures] == [True]
    assert loop.step_idx == 4
    assert [int(s["meta"]["step"]) for s in ck.saved] == [2, 4, 4]
    cold = _loop(cfg, checkpointer=ck)
    assert cold.restore_if_available() and cold.step_idx == 4
    for a, b in zip(tree_leaves(cold.params), tree_leaves(loop.params)):
        assert torch.equal(a, b)
    assert int(cold.opt_state["step"]) == int(loop.opt_state["step"])


def test_train_loop_gives_up_after_max_retries():
    cfg = small_cfg()

    def always_fail(step):
        raise WorkerFailure("node is gone")

    loop = _loop(cfg, failure_injector=always_fail)
    with pytest.raises(WorkerFailure):
        loop.run(2, max_retries=2)
    assert loop.step_idx == 0
