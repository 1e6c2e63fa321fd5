"""The port's rwkv6 model and WKV plain version against the JAX package.

``rwkv6-7b.reduced()`` (2 layers, d 64, 4 heads of 16) with the JAX weights
brought across by ``params_from_numpy``. The zero-initialised leaves ``u``,
``w0`` and ``mu_*`` get seeded noise in the JAX tree first, so that the bonus
term, the decay offset and the token shift are exercised. At fp32 the two
agree to 1e-4 (sums in another order). The WKV sweep uses the tolerance of
tests/test_kernels.py's own WKV sweep, 1e-4.

In bf16 the JAX reference runs with ``unroll=True``: op by op, each bf16
result rounded as the code is written, as the port rounds it. Under
``lax.scan`` XLA fuses the layer body and keeps bf16 intermediates in fp32
(excess precision), which moves the reduced model's logits by up to ~0.07
on a magnitude of 3; the unrolled path is the same arithmetic without that
fusion (and ``unroll`` changes nothing else: the WKV scan is fp32 either
way). The bf16 case allows 3e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Init, init_model as jax_init_model, unbox
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import alloc_cache, get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels.rwkv_wkv import (CHUNK_STEPS, COL_BLOCKS, HEAD_DIMS,
                                          ROW_LANES, wkv_plain)
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv as trwkv
from test_torch_dense_variants import NoLibrary, card_route  # noqa: F401

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=3e-2, rtol=3e-2)
ARCH = "rwkv6-7b"
NOISY = ("u", "w0", "mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g")


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def configs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, **kw)
    return jcfg, tcfg


def noisy_jax_params(jcfg, seed=0):
    """The JAX tree with seeded noise on the zero-initialised leaves, as JAX
    arrays and as numpy."""
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(100 + seed)
    dec = tree["dec"]
    for name in NOISY:
        a = dec["tm"][name]
        dec["tm"][name] = rng.normal(0, 0.5, a.shape).astype(a.dtype)
    for name in ("mu_k", "mu_r"):
        a = dec["cm"][name]
        dec["cm"][name] = rng.normal(0, 0.5, a.shape).astype(a.dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.jnp_dtype), tree)
    return jp, tree


def weights(jcfg, tcfg, seed=0):
    jp, tree = noisy_jax_params(jcfg, seed)
    return jp, params_from_numpy(tree, tcfg, device="cpu")


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def fp32_pair():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


# ---------------------------------------------------------------------------
# the WKV plain version
# ---------------------------------------------------------------------------

def wkv_inputs(seed, B, S, H, hd):
    """r/k/v/w (B,S,H,hd) as numpy, w in (0.8, 0.999), and u (H,hd)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, hd)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.8, 0.999, (B, S, H, hd)).astype(np.float32)
    u = rng.normal(0, 1, (H, hd)).astype(np.float32)
    return r, k, v, w, u


def bhsd(a):
    """(B,S,H,hd) -> the TPU kernel's (B,H,S,hd), as JAX array."""
    return jnp.asarray(np.swapaxes(a, 1, 2))


def t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("B,H,S,hd", [(2, 3, 128, 64), (1, 2, 64, 32),
                                      (2, 4, 64, 16)])
@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv_plain_vs_pallas(B, H, S, hd, chunk):
    """tests/test_kernels.py's WKV sweep; the Pallas kernel in interpret mode."""
    r, k, v, w, u = wkv_inputs(0, B, S, H, hd)
    yg, sg = jops.wkv(bhsd(r), bhsd(k), bhsd(v), bhsd(w), jnp.asarray(u),
                      chunk=chunk)
    y, s = wkv_plain(t(r), t(k), t(v), t(w), t(u))
    np.testing.assert_allclose(f32(y), np.swapaxes(np.asarray(yg), 1, 2), **F32)
    np.testing.assert_allclose(f32(s), np.asarray(sg), **F32)


def test_wkv_plain_ragged_vs_ref():
    """S = 37, which the Pallas kernel refuses (S % chunk != 0)."""
    r, k, v, w, u = wkv_inputs(1, 2, 37, 3, 16)
    yg, sg = jref.ref_wkv(bhsd(r), bhsd(k), bhsd(v), bhsd(w), jnp.asarray(u))
    y, s = wkv_plain(t(r), t(k), t(v), t(w), t(u))
    np.testing.assert_allclose(f32(y), np.swapaxes(np.asarray(yg), 1, 2), **F32)
    np.testing.assert_allclose(f32(s), np.asarray(sg), **F32)


@pytest.mark.parametrize("dtype,tol", [("float32", F32),
                                       ("bfloat16", dict(atol=2e-2, rtol=2e-2))])
def test_wkv_plain_with_state_vs_wkv_scan(dtype, tol):
    """The model's wkv_scan with a nonzero s0; bf16 r/k/v/u with fp32 w."""
    B, S, H, hd = 2, 24, 3, 16
    r, k, v, w, u = wkv_inputs(2, B, S, H, hd)
    s0 = np.random.default_rng(3).normal(0, 1, (B, H, hd, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, js = jrwkv.wkv_scan(*(jnp.asarray(a, jdt) for a in (r, k, v)),
                            jnp.asarray(w), jnp.asarray(u, jdt),
                            jnp.asarray(s0), chunk=8)
    y, s = wkv_plain(*(t(a).to(tdt) for a in (r, k, v)), t(w), t(u).to(tdt),
                     t(s0))
    assert y.dtype == tdt and s.dtype == torch.float32
    np.testing.assert_allclose(f32(y), f32(jy), **tol)
    np.testing.assert_allclose(f32(s), f32(js), **tol)


def test_wkv_wrapper_on_cpu_takes_plain_and_updates_state_in_place(no_library):
    r, k, v, w, u = (t(a) for a in wkv_inputs(4, 2, 5, 3, 16))
    s0 = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(0))
    y_ref, s_ref = wkv_plain(r, k, v, w, u, s0)
    state = s0.clone()
    y, s = tops.wkv(r, k, v, w, u, s0=state, state_out=state)
    assert s is state
    assert torch.equal(y, y_ref) and torch.equal(state, s_ref)
    y0, _ = tops.wkv(r, k, v, w, u)
    assert torch.equal(y0, wkv_plain(r, k, v, w, u)[0])


def _wkv_partition(r, k, v, w, u, s0, T):
    """csrc/rwkv_wkv.cu's schedule in plain torch (fp32) at r's head dim.
    Each of COL_BLOCKS[hd] blocks owns 16 state columns; each of
    ROW_LANES[hd] = 4 lanes of a column keeps hd // 4 state rows. Time runs
    over staged chunks of T steps, the last one ragged. Each lane sums its
    partial of y_t over its rows in order, and y_t = (p0 + p1) + (p2 + p3),
    as they are added from shared memory. The state update is wkv_plain's,
    element by element. The decode kernel (S = 1) cuts the columns
    otherwise (min(32, hd) a warp) but keeps the row lanes and the order
    of y's sum, so this replays it too."""
    B, S, H, hd = r.shape
    n_blocks, n_lanes = COL_BLOCKS[hd], ROW_LANES[hd]
    assert n_lanes == 4, "y's sum below adds 4 partials"
    nc, nr = hd // n_blocks, hd // n_lanes
    state = torch.zeros((B, H, hd, hd)) if s0 is None else s0.clone()
    y = torch.full((B, S, H, hd), float("nan"))
    uf = u.float()[None]
    for cb in range(n_blocks):
        cols = slice(cb * nc, (cb + 1) * nc)
        lanes = [slice(q * nr, (q + 1) * nr) for q in range(n_lanes)]
        st = [state[:, :, rows, cols].clone() for rows in lanes]
        for t0 in range(0, S, T):
            rc, kc, wc = (x[:, t0:t0 + T].float() for x in (r, k, w))
            vc = v[:, t0:t0 + T, :, cols].float()
            for t in range(rc.shape[1]):
                parts = []
                for q, rows in enumerate(lanes):
                    kv = kc[:, t, :, rows, None] * vc[:, t, :, None, :]
                    term = rc[:, t, :, rows, None] * (st[q] + uf[:, :, rows, None] * kv)
                    acc = torch.zeros((B, H, nc))
                    for i in range(nr):
                        acc = acc + term[:, :, i]
                    parts.append(acc)
                    st[q] = wc[:, t, :, rows, None] * st[q] + kv
                y[:, t0 + t, :, cols] = (parts[0] + parts[1]) + (parts[2] + parts[3])
        for rows, s_q in zip(lanes, st):
            state[:, :, rows, cols] = s_q
    return y, state


@pytest.mark.parametrize("T,S", [(32, 1), (32, 31), (32, 33), (32, 37),
                                 (16, 1), (16, 15), (16, 17), (16, 37)])
@pytest.mark.parametrize("s0", ["zero", "random"])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_wkv_partition_replay(T, S, s0, hd):
    """The kernel's partition at head dim hd (hd // 16 column blocks of 16,
    4 row lanes a column, chunks of T = 32 (bf16) or 16 (fp32) with a
    ragged tail) against wkv_plain (y within 3e-5, the state bit for bit)
    and against JAX: the Pallas kernel in interpret mode from a zero state,
    wkv_scan from a random one."""
    B, H = 2, 2
    r, k, v, w, u = wkv_inputs(5, B, S, H, hd)
    s0_np = (None if s0 == "zero" else
             np.random.default_rng(6).normal(0, 1, (B, H, hd, hd)).astype(np.float32))
    s0_t = None if s0_np is None else t(s0_np)
    y, s = _wkv_partition(t(r), t(k), t(v), t(w), t(u), s0_t, T)
    yp, sp = wkv_plain(t(r), t(k), t(v), t(w), t(u), s0_t)
    tol = dict(atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(f32(y), f32(yp), **tol)
    assert torch.equal(s, sp)
    if s0_np is None:
        yg, sg = jops.wkv(bhsd(r), bhsd(k), bhsd(v), bhsd(w), jnp.asarray(u),
                          chunk=S)
        yg = np.swapaxes(np.asarray(yg), 1, 2)
    else:
        yg, sg = jrwkv.wkv_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                jnp.asarray(s0_np), chunk=8)
    np.testing.assert_allclose(f32(y), f32(yg), **tol)
    np.testing.assert_allclose(f32(s), f32(sg), **tol)


def test_wkv_head_dims_and_partition():
    """The kernel is built at head dims 16 (the reduced configs'), 32 and 64
    (rwkv6-7b's); its partition per head dim is the one the replay above
    holds: hd // 16 column blocks of 16 at a prefill, 4 row lanes of hd // 4
    rows."""
    assert HEAD_DIMS == (16, 32, 64)
    assert COL_BLOCKS == {16: 1, 32: 2, 64: 4}
    assert ROW_LANES == {16: 4, 32: 4, 64: 4}
    assert CHUNK_STEPS == {torch.bfloat16: 32, torch.float32: 16}
    for arch in ("rwkv6-7b",):
        assert get_config(arch).ssm.head_dim in HEAD_DIMS
        assert get_config(arch).reduced().ssm.head_dim in HEAD_DIMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_wrapper_takes_built_head_dims_on_the_card_route(card_route, dtype):
    """On the card route (the device check bypassed, the library replaced
    by a sentinel) every built head dim passes the wrapper's checks and
    reaches the library; head dim 48 raises before it."""
    for hd in HEAD_DIMS + (48,):
        r = torch.zeros((2, 3, 4, hd), dtype=dtype)
        w = torch.full((2, 3, 4, hd), 0.9)
        call = lambda: tops.wkv(r, r, r, w, torch.zeros((4, hd), dtype=dtype))  # noqa: E731
        with pytest.raises(ValueError if hd == 48 else NoLibrary):
            call()


def test_smoke_launcher_serves_rwkv6_as_the_jax_engine(capsys):
    """``launch.serve --smoke --arch rwkv6-7b --device cpu``: the reduced
    rwkv6 (head dim 16, vocab 512, the config's bf16) serves its requests,
    and the JAX engine on the launcher's own weights, carried across in the
    JAX layout, decodes the same greedy tokens."""
    from repro.serving import ServingEngine as JaxServingEngine
    from repro_torch.bridge import to_jax_layout
    from repro_torch.launch import serve

    eng = serve.main(["--smoke", "--arch", ARCH, "--device", "cpu",
                      "--requests", "3", "--max-new", "8"])
    out = capsys.readouterr().out
    assert out.count(" -> ") == 3 and "'finished': 3" in out
    assert eng.cfg.ssm.head_dim == 16 and eng.cfg.vocab_size == 512
    # unrolled: bf16 rounded op by op, as the port rounds it (module doc)
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(), vocab_size=512,
                               unroll=True)
    assert jcfg.dtype == eng.cfg.dtype
    jp = jax.tree.map(lambda a: jnp.asarray(a.float().numpy(), jcfg.jnp_dtype),
                      to_jax_layout(eng.params, eng.cfg))
    jeng = JaxServingEngine(jcfg, jp, max_batch=eng.max_batch,
                            max_len=eng.max_len)
    jreqs = [jeng.submit(serve.PROMPTS[i], max_new_tokens=8) for i in range(3)]
    jeng.run_until_done()
    tout = [r.out_ids for r in sorted(eng.finished, key=lambda r: r.rid)]
    assert tout == [r.out_ids for r in jreqs]
    assert all(len(o) == 8 for o in tout)


# ---------------------------------------------------------------------------
# time mix, channel mix
# ---------------------------------------------------------------------------

def layer_inputs(tcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    H, hd = tcfg.n_ssm_heads, tcfg.ssm.head_dim
    x = rng.normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    shift = rng.normal(0, 1, (B, tcfg.d_model)).astype(np.float32)
    state = rng.normal(0, 0.5, (B, H, hd, hd)).astype(np.float32)
    return x, shift, state


def layer(jp, tp, name, l=0):
    return (jax.tree.map(lambda a: a[l], jp["dec"][name]),
            tp["layers"][l][name])


def test_time_mix_matches_jax(fp32_pair):
    jcfg, tcfg, jp, tp = fp32_pair
    jl, tl = layer(jp, tp, "tm")
    x, shift, state = layer_inputs(tcfg, 2, 11, seed=5)
    jo, jsh, js = jrwkv.time_mix(jl, jcfg, jnp.asarray(x), jnp.asarray(shift),
                                 jnp.asarray(state))
    to, tsh, ts = trwkv.time_mix(tl, tcfg, t(x), t(shift), t(state))
    for a, b in ((to, jo), (tsh, jsh), (ts, js)):
        np.testing.assert_allclose(f32(a), f32(b), **F32)


def test_time_mix_step_matches_jax_and_updates_state_in_place(fp32_pair):
    jcfg, tcfg, jp, tp = fp32_pair
    jl, tl = layer(jp, tp, "tm", l=1)
    x, shift, state = layer_inputs(tcfg, 3, 1, seed=6)
    jo, jsh, js = jrwkv.time_mix_step(jl, jcfg, jnp.asarray(x),
                                      jnp.asarray(shift), jnp.asarray(state))
    tstate = t(state)
    to, tsh, ts = trwkv.time_mix_step(tl, tcfg, t(x), t(shift), tstate)
    assert ts is tstate
    for a, b in ((to, jo), (tsh, jsh), (tstate, js)):
        np.testing.assert_allclose(f32(a), f32(b), **F32)


@pytest.mark.parametrize("S", [1, 9])
def test_channel_mix_matches_jax(fp32_pair, S):
    jcfg, tcfg, jp, tp = fp32_pair
    jl, tl = layer(jp, tp, "cm")
    x, shift, _ = layer_inputs(tcfg, 2, S, seed=7)
    jo, jsh = jrwkv.channel_mix(jl, jcfg, jnp.asarray(x), jnp.asarray(shift))
    to, tsh = trwkv.channel_mix(tl, tcfg, t(x), t(shift))
    np.testing.assert_allclose(f32(to), f32(jo), **F32)
    np.testing.assert_allclose(f32(tsh), f32(jsh), **F32)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

CACHE_KEYS = ("ssm_state", "shift_tm", "shift_cm")


def test_forward_hidden_matches_jax(fp32_pair):
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 2, 20)
    jh, _, _ = jmodel.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                              is_train=False)
    th, cache = tmodel.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                               is_train=False)
    assert cache is None
    np.testing.assert_allclose(f32(th), f32(jh), **F32)


def test_prefill_logits_and_cache_match_jax(fp32_pair):
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 3, 13, seed=2)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 max_len=40)
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=40)
    assert tl.shape == (3, 1, tcfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    assert set(tc) == set(jc) == {"pos", *CACHE_KEYS}
    for k in CACHE_KEYS:
        assert tuple(tc[k].shape) == jc[k].shape
        assert f32(tc[k]).dtype == np.asarray(jc[k]).astype(np.float32).dtype
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32)
    assert tc["ssm_state"].dtype == torch.float32
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_steps_match_jax(fp32_pair):
    """Per-step logits and every cache leaf over 6 greedy decode steps."""
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 2, 8, seed=3)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    jdec = jax.jit(functools.partial(jmodel.decode_step, jcfg))
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(6):
        jl, jc = jdec(jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **F32)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for k in CACHE_KEYS:
        np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_matches_forward(fp32_pair):
    """Prefill(S) + decode(tokens S, S+1) equals forward over S+2 tokens."""
    _, tcfg, _, tp = fp32_pair
    B, S = 2, 10
    toks = torch.from_numpy(tokens(tcfg, B, S + 2, seed=4))
    h, _ = tmodel.forward(tcfg, tp, {"tokens": toks}, is_train=False)
    cache, logits = tmodel.prefill_step(tcfg, tp, {"tokens": toks[:, :S]})
    np.testing.assert_allclose(f32(logits), f32(tmodel._unembed(tcfg, tp, h[:, S - 1:S])),
                               **F32)
    for i in (S, S + 1):
        logits, cache = tmodel.decode_step(tcfg, tp, toks[:, i:i + 1], cache)
        np.testing.assert_allclose(
            f32(logits), f32(tmodel._unembed(tcfg, tp, h[:, i:i + 1])), **F32)


def test_bf16_prefill_and_decode_close_to_jax():
    jcfg, tcfg = configs("bfloat16")
    jcfg = dataclasses.replace(jcfg, unroll=True)
    jp, tp = weights(jcfg, tcfg, seed=5)
    assert tp["layers"][0]["tm"]["wr"].dtype == torch.bfloat16
    toks = tokens(tcfg, 2, 12, seed=6)
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)})
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    assert tc["shift_tm"].dtype == torch.bfloat16
    np.testing.assert_allclose(f32(tl), f32(jl), **BF16)
    for _ in range(2):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tcfg, tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **BF16)


def test_alloc_cache_layout_matches_cache_specs():
    from repro.configs.shapes import cache_specs
    jcfg, tcfg = configs("bfloat16")
    specs = cache_specs(jcfg, 3, 32)
    cache = alloc_cache(tcfg, 3, 32, torch.device("cpu"))
    assert set(cache) == set(specs)
    for k, spec in specs.items():
        assert tuple(cache[k].shape) == spec.shape, k
        assert str(cache[k].dtype).split(".")[-1] == str(spec.dtype), k
        assert not cache[k].any()


def test_port_init_model_matches_jax_tree():
    """Names, shapes and dtypes of the port's own init against the JAX tree,
    and the zero/one leaves where the reference puts them."""
    jcfg, tcfg = configs("bfloat16")
    _, ref_tree = noisy_jax_params(jcfg)
    ref = params_from_numpy(ref_tree, tcfg, device="cpu")
    p = tmodel.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(p) == set(ref) == {"embed", "final_norm", "unembed", "layers"}
    for lp, rp in zip(p["layers"], ref["layers"]):
        assert set(lp) == set(rp) == {"norm1", "norm2", "tm", "cm"}
        for grp in ("tm", "cm"):
            assert set(lp[grp]) == set(rp[grp])
            for k in rp[grp]:
                assert lp[grp][k].shape == rp[grp][k].shape, (grp, k)
                assert lp[grp][k].dtype == rp[grp][k].dtype
        tm = lp["tm"]
        for k in NOISY:
            assert not tm[k].any(), k
        assert (tm["ln_x"] == 1).all()
        assert not lp["cm"]["mu_k"].any() and not lp["cm"]["mu_r"].any()
