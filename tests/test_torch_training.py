"""The port's training against the JAX package: the schedule, AdamW, the
loss and every gradient leaf; the training route and the wrappers' refusal
of autograd on the card. The train step and loop are in
tests/test_torch_train_loop.py.

The JAX weights come across by ``params_from_numpy`` (never re-seeded), and
JAX's gradient tree by the same bridge at fp32. Tolerances are ROADMAP's:
3e-5 at fp32 (absolute and relative, element by element) and 2e-2 at bf16.
``rwkv6-7b.reduced()`` gets seeded noise on its zero-initialised leaves
(``noisy_jax_params``), so that the bonus, decay offset and token shift
carry gradient. The dense case at S 1024 takes ``chunked_xent``'s branch
of two 512-token chunks.
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
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.models import model as tmodel
from repro_torch.models.common import grad_cast
from repro_torch.training import (AdamWConfig, adamw_update, init_opt_state,
                                  schedule)
from repro_torch.training.optimizer import global_norm, tree_leaves
from repro_torch.training.train_loop import loss_and_grads
from test_torch_rwkv import noisy_jax_params

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def setup(arch, dtype="float32", seed=0):
    """(jcfg, tcfg, JAX params, port params) on the same numbers."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    if arch == "rwkv6-7b":
        jp, tree = noisy_jax_params(jcfg, seed)
    else:
        jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                          dtype=jcfg.jnp_dtype), jcfg))
        tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, params_from_numpy(tree, tcfg, device="cpu")


def batches(cfg, B, S, seed=1):
    """The same tokens/targets as a JAX and a port batch."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    tok, tgt = toks[:, :-1].copy(), toks[:, 1:].copy()
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)})


def grads_to_port(jgrads, tcfg):
    """JAX's gradient tree as the port's tree, in fp32."""
    return params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg,
                             device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# schedule and AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 10), (5, 5)])
def test_schedule_matches_jax(warmup, total):
    tc = AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    jc = jopt.AdamWConfig(lr=1e-3, warmup_steps=warmup, total_steps=total)
    for s in (0, 1, 5, 10, 50, 100):
        got = schedule(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jopt.schedule(
            jc, jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=0)


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(schedule(cfg, torch.tensor(s))) for s in (1, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] == pytest.approx(1e-3, rel=0.05)
    assert lrs[4] == pytest.approx(1e-4, rel=0.1)       # min_lr_frac


def test_adamw_moves_params_against_gradient():
    params = {"w": torch.ones((4,))}
    grads = {"w": torch.ones((4,))}
    opt = init_opt_state(params)
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0, total_steps=10)
    p2, opt2, m = adamw_update(cfg, params, grads, opt)
    assert (p2["w"] < 1.0).all()
    assert int(opt2["step"]) == 1 and opt2["step"].dtype == torch.int32
    assert m["grad_norm"] > 0
    assert torch.equal(params["w"], torch.ones((4,)))   # inputs unchanged


def _opt_tree(rng, dtype):
    """A small nested tree (dicts and a list, as the model's) in numpy."""
    shapes = {"embed": (6, 8), "layers": [{"w": (8, 5), "b": (5,)},
                                          {"w": (8, 5), "b": (5,)}]}
    return jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.5, 1e9], ids=["clip-active", "clip-inactive"])
def test_adamw_update_matches_jax(dtype, clip):
    """Two updates on identical params and grads: params, mu, nu, step, lr
    and grad_norm against JAX's."""
    rng = np.random.default_rng(0)
    p_np = _opt_tree(rng, dtype)
    g_np = [_opt_tree(rng, dtype) for _ in range(2)]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = jax.tree.map(lambda a: torch.tensor(a).to(tdt), p_np)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=clip)
    jc, tc = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    jo, to = jopt.init_opt_state(jp), init_opt_state(tp)
    for g in g_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g)
        tg = jax.tree.map(lambda a: torch.tensor(a).to(tdt), g)
        jp, jo, jm = jopt.adamw_update(jc, jp, jg, jo)
        tp, to, tm = adamw_update(tc, tp, tg, to)
        tol = F32 if dtype == "float32" else BF16
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == tdt and not a.requires_grad
            np.testing.assert_allclose(f32(a), f32(b), **tol)
        for k in ("mu", "nu"):
            for a, b in zip(tree_leaves(to[k]), jax.tree.leaves(jo[k])):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(f32(a), f32(b), **F32)
        assert int(to["step"]) == int(jo["step"])
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    if clip == 0.5:
        assert float(tm["grad_norm"]) > clip            # the clip did act


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

CASES = {"dense": ("dcache-agent-150m", 4, 16),
         "rwkv6": ("rwkv6-7b", 4, 16),
         "dense-S1024": ("dcache-agent-150m", 1, 1024)}


@pytest.fixture(scope="module", params=list(CASES))
def fp32_case(request):
    """One JAX value_and_grad per case, shared by the tests of the module."""
    arch, B, S = CASES[request.param]
    jcfg, tcfg, jp, tp = setup(arch)
    jb, tb = batches(tcfg, B, S)
    (jtotal, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    return dict(tcfg=tcfg, tp=tp, tb=tb, jtotal=jtotal, jm=jm,
                jg=grads_to_port(jg, tcfg))


def test_loss_and_every_gradient_match_jax(fp32_case):
    c = fp32_case
    grads, m = loss_and_grads(c["tcfg"], c["tp"], c["tb"])
    for k in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose(f32(m[k]), f32(c["jm"][k]), **F32)
    total, _ = tmodel.loss_fn(c["tcfg"], c["tp"], c["tb"])
    np.testing.assert_allclose(f32(total), f32(c["jtotal"]), **F32)
    got, want = tree_leaves(grads), tree_leaves(c["jg"])
    assert len(got) == len(want) == len(tree_leaves(c["tp"]))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(f32(a), f32(b), **F32)
    assert global_norm(grads) > 0


def test_chunked_xent_takes_512_chunks_at_s1024():
    tcfg = get_config("dcache-agent-150m").reduced()
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    p = tmodel.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    h = torch.randn((1, 1024, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    t = torch.randint(0, tcfg.vocab_size, (1, 1024), generator=torch.Generator().manual_seed(2))
    loss, acc = tmodel.chunked_xent(tcfg, p, h, t)
    one, acc1 = tmodel.chunked_xent(tcfg, p, h, t, chunk=1024)
    np.testing.assert_allclose(float(loss), float(one), rtol=1e-6)
    assert float(acc) == float(acc1)
    logits = h @ p["embed"].t()
    ref = torch.nn.functional.cross_entropy(logits[0, :, :tcfg.vocab_size], t[0])
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)


def test_bf16_loss_and_grad_norm_match_jax():
    jcfg, tcfg, jp, tp = setup("dcache-agent-150m", "bfloat16")
    jb, tb = batches(tcfg, 4, 16)
    (_, jm), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    grads, m = loss_and_grads(tcfg, tp, tb)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))
    np.testing.assert_allclose(f32(m["loss"]), f32(jm["loss"]), **BF16)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(jopt.global_norm(jg)), **BF16)


def test_training_route_equals_serving_route_at_fp32():
    """forward(is_train=True) (plain torch ops, remat) and the serving route
    (the kernels' plain versions on the CPU) give the same hidden states."""
    for arch in ("dcache-agent-150m", "rwkv6-7b"):
        _, tcfg, _, tp = setup(arch)
        _, tb = batches(tcfg, 2, 12)
        h_train, _ = tmodel.forward(tcfg, tp, tb, is_train=True)
        h_serve, _ = tmodel.forward(tcfg, tp, tb, is_train=False)
        np.testing.assert_allclose(f32(h_train), f32(h_serve), atol=1e-5, rtol=1e-5)


def test_remat_block_and_dots_equal_no_remat():
    """block and dots (ported; it raised before) give no remat's gradients.
    The policy itself is tested in tests/test_torch_remat.py."""
    _, tcfg, _, tp = setup("dcache-agent-150m")
    _, tb = batches(tcfg, 2, 12)
    assert tcfg.remat == "block"
    g_none, _ = loss_and_grads(dataclasses.replace(tcfg, remat="none"), tp, tb)
    for remat in ("block", "dots"):
        g, _ = loss_and_grads(dataclasses.replace(tcfg, remat=remat), tp, tb)
        for a, b in zip(tree_leaves(g), tree_leaves(g_none)):
            np.testing.assert_allclose(f32(a), f32(b), atol=1e-6, rtol=1e-6)


def test_grad_cast_identity_forward_casts_cotangent():
    x = torch.linspace(-1, 1, 7, requires_grad=True)
    y = grad_cast(x, torch.bfloat16)
    assert torch.equal(y, x) and y.dtype == torch.float32
    w = torch.full((7,), 1.0 + 2 ** -12)      # not representable in bf16
    (y * w).sum().backward()
    assert torch.equal(x.grad, torch.ones(7))  # the cotangent went through bf16


# ---------------------------------------------------------------------------
# the kernel wrappers refuse autograd on the card
# ---------------------------------------------------------------------------

def test_refuse_autograd_raises_only_for_grad_inputs_under_grad_mode():
    x = torch.ones(4, requires_grad=True)
    y = torch.ones(4)
    with pytest.raises(RuntimeError, match="training route"):
        _build.refuse_autograd("rmsnorm", y, x)
    _build.refuse_autograd("rmsnorm", y, y)
    with torch.no_grad():
        _build.refuse_autograd("rmsnorm", x, y)


def test_cpu_wrappers_stay_differentiable():
    """CPU inputs take the plain version, which autograd differentiates."""
    x = torch.randn(3, 64, requires_grad=True)
    g = torch.ones(64, requires_grad=True)
    assert _build.use_plain("rmsnorm", x, g)
    tops.rmsnorm(x, g).sum().backward()
    assert x.grad is not None and g.grad is not None
