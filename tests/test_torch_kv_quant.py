"""The port's int8 KV cache (``cfg.kv_quant``) against the JAX package's.

Quantize and dequantize on seeded numpy inputs; the int8 decode kernel's
plain version against JAX ``dequantize_kv`` + ``ref_decode_attention`` and
the Pallas ``decode_attention`` (interpret mode) on the dequantized cache,
over the sweep of tests/test_kernels.py (3e-5 at fp32, 2e-2 at bf16); and
``dcache-agent-150m.reduced()`` with ``kv_quant=True`` on both sides, the
JAX-initialised weights brought across by ``params_from_numpy``: prefill
and six decode steps at fp32 within 1e-4 with equal int8 codes, and the
engine's greedy tokens.

JAX's eager ``quantize_kv`` divides max|x| by 127 as the port does, so the
two give equal scales. Inside a jitted or scanned JAX function XLA turns
that division by a constant into a product with 1/127, so the JAX model's
fp32 scales may differ from the port's by one ulp; the model tests allow
1e-4 on the scales and still need equal codes.
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
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import alloc_cache, get_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import decode_attention_int8_plain
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.serving import ServingEngine

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32 = dict(atol=1e-4, rtol=1e-4)


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def both(a, dtype):
    """numpy float32 -> (JAX array, torch tensor) in dtype."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvh,hd", [(2, 16), (4, 64)])
def test_quantize_kv_matches_jax(dtype, kvh, hd):
    """Codes equal; scales equal (bf16) or within 1e-7 relative (fp32);
    all-zero heads get scale 1.0 and code 0; dequantize_kv equal."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0, 1, (3, 7, kvh * hd)) * rng.uniform(0.01, 10, (3, 7, 1))
         ).astype(np.float32)
    x[0, 2] = 0.0                        # a whole token: every head zero
    x[1, 4, :hd] = 0.0                   # one head of a token
    jx, tx = both(x, dtype)
    jq, js = jattn.quantize_kv(jx, kvh)
    tq, ts = tattn.quantize_kv(tx, kvh)
    assert tq.dtype == torch.int8 and tq.shape == tx.shape
    assert ts.dtype == tx.dtype and tuple(ts.shape) == (3, 7, kvh)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(f32(ts), f32(js))
    else:
        np.testing.assert_allclose(f32(ts), f32(js), rtol=1e-7, atol=0)
    assert (f32(ts)[0, 2] == 1.0).all() and f32(ts)[1, 4, 0] == 1.0
    assert (tq[0, 2] == 0).all()
    jd = jattn.dequantize_kv(jq, js, jx.dtype)
    td = tattn.dequantize_kv(tq, ts, tx.dtype)
    assert td.dtype == tx.dtype
    np.testing.assert_array_equal(f32(td), f32(jd))


def test_quantize_round_trip_uses_the_stored_scale():
    """In bf16 the scale used to dequantize is the bf16-rounded one, so a
    round trip is not the identity, on either side."""
    x = np.random.default_rng(1).normal(0, 3, (64, 128)).astype(np.float32)
    _, tx = both(x, "bfloat16")
    tq, ts = tattn.quantize_kv(tx, 2)
    back = tattn.dequantize_kv(tq, ts, torch.bfloat16)
    err = (back.float() - tx.float()).abs()
    step = ts.float().repeat_interleave(64, dim=-1)
    assert (err <= 0.5 * step + 0.02 * tx.float().abs() + 1e-6).all()
    assert not torch.equal(back, tx)


# ---------------------------------------------------------------------------
# the int8 decode kernel's plain version
# ---------------------------------------------------------------------------

def int8_ring(seed, B, Hkv, C, d, dtype):
    """A quantized ring from seeded K/V: the JAX (B,C,KV*hd) codes and
    (B,C,KV) scales, and the port's (B,KV,C,hd) / (B,KV,C) views of the
    same values."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.normal(0, 1, (B, C, Hkv * d)).astype(np.float32)
        jx, tx = both(x, dtype)
        jq, js = jattn.quantize_kv(jx, Hkv)
        tq = torch.from_numpy(np.array(jq))
        ts = torch.from_numpy(np.array(js, np.float32)).to(DTYPES[dtype][1])
        out.append((jq, js, tq.view(B, C, Hkv, d).transpose(1, 2),
                    ts.transpose(1, 2)))
    return out


def jax_dequantized(jq, js, Hkv, dtype):
    B, C, F = jq.shape
    kd = jattn.dequantize_kv(jq, js, DTYPES[dtype][0])
    return kd.reshape(B, C, Hkv, F // Hkv).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,Hq,Hkv,C,d", [
    (2, 4, 2, 256, 64), (3, 8, 8, 128, 32), (1, 16, 2, 512, 128),
])
@pytest.mark.parametrize("mask", ["none", "window", "chunk"])
@pytest.mark.parametrize("gold", ["ref", "pallas"])
def test_int8_plain_vs_jax(B, Hq, Hkv, C, d, mask, gold):
    kw = {"none": {}, "window": dict(window=64), "chunk": dict(chunk=128)}[mask]
    (jkq, jks, tkq, tks), (jvq, jvs, tvq, tvs) = int8_ring(4, B, Hkv, C, d,
                                                           "float32")
    rng = np.random.default_rng(5)
    jq, tq = both(rng.normal(0, 1, (B, Hq, d)).astype(np.float32), "float32")
    pos = rng.integers(1, 3 * C, B).astype(np.int32)
    kd = jax_dequantized(jkq, jks, Hkv, "float32")
    vd = jax_dequantized(jvq, jvs, Hkv, "float32")
    if gold == "ref":
        want = jref.ref_decode_attention(jq, kd, vd, jnp.asarray(pos), **kw)
    else:
        want = jops.decode_attention(jq, kd, vd, jnp.asarray(pos), block_k=64,
                                     **kw)
    out = decode_attention_int8_plain(tq, tkq, tvq, tks, tvs,
                                      torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(out.numpy(), f32(want), **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_dtypes(dtype):
    B, Hq, Hkv, C, d = 4, 12, 4, 128, 64
    (jkq, jks, tkq, tks), (jvq, jvs, tvq, tvs) = int8_ring(7, B, Hkv, C, d, dtype)
    rng = np.random.default_rng(8)
    jq, tq = both(rng.normal(0, 1, (B, Hq, d)).astype(np.float32), dtype)
    pos = np.asarray([5, 127, 300, 64], np.int32)
    want = jops.decode_attention(jq, jax_dequantized(jkq, jks, Hkv, dtype),
                                 jax_dequantized(jvq, jvs, Hkv, dtype),
                                 jnp.asarray(pos), block_k=64, window=100)
    out = decode_attention_int8_plain(tq, tkq, tvq, tks, tvs,
                                      torch.from_numpy(pos), window=100)
    assert out.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(f32(out), f32(want), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_empty_and_pad_slots(dtype):
    """A ring as the engine holds it: slots never written (codes 0, scale
    0) and prefill pad slots (codes 0, scale 1.0) beside real tokens. Both
    are masked; the output is finite and equals JAX's."""
    B, Hq, Hkv, C, d = 2, 12, 4, 64, 64
    (jkq, jks, tkq, tks), (jvq, jvs, tvq, tvs) = int8_ring(9, B, Hkv, C, d, dtype)
    pos = np.asarray([5, 20], np.int32)
    ks, vs = f32(jks).copy(), f32(jvs).copy()
    kq, vq = np.asarray(jkq).copy(), np.asarray(jvq).copy()
    for b, p in enumerate(pos):
        kq[b, p + 1:], vq[b, p + 1:] = 0, 0
        ks[b, p + 1:p + 4], vs[b, p + 1:p + 4] = 1.0, 1.0    # pad slots
        ks[b, p + 4:], vs[b, p + 4:] = 0.0, 0.0              # empty slots
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    jq, tq = both(rng.normal(0, 1, (B, Hq, d)).astype(np.float32), dtype)

    def port(a):
        return torch.from_numpy(a).view(B, C, Hkv, -1).transpose(1, 2)

    out = decode_attention_int8_plain(
        tq, port(kq), port(vq), torch.from_numpy(ks).to(tdt).transpose(1, 2),
        torch.from_numpy(vs).to(tdt).transpose(1, 2), torch.from_numpy(pos))
    want = jref.ref_decode_attention(
        jq, jax_dequantized(jnp.asarray(kq), jnp.asarray(ks, jdt), Hkv, dtype),
        jax_dequantized(jnp.asarray(vq), jnp.asarray(vs, jdt), Hkv, dtype),
        jnp.asarray(pos))
    assert torch.isfinite(out.float()).all()
    np.testing.assert_allclose(f32(out), f32(want), **tol(dtype))


def test_int8_wrapper_on_cpu_takes_plain(no_library):
    """On the CPU the wrapper is the plain version and never reaches the
    kernel library."""
    B, Hq, Hkv, C, d = 2, 12, 4, 64, 64
    (_, _, tkq, tks), (_, _, tvq, tvs) = int8_ring(11, B, Hkv, C, d, "float32")
    q = torch.randn(B, Hq, d, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([3, 70], dtype=torch.int32)
    assert torch.equal(tops.decode_attention_int8(q, tkq, tvq, tks, tvs, pos),
                       decode_attention_int8_plain(q, tkq, tvq, tks, tvs, pos))


# ---------------------------------------------------------------------------
# the model with kv_quant
# ---------------------------------------------------------------------------

def configs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_config("dcache-agent-150m").reduced(),
                               dtype=dtype, kv_quant=True, **kw)
    tcfg = dataclasses.replace(get_config("dcache-agent-150m").reduced(),
                               dtype=dtype, kv_quant=True, **kw)
    return jcfg, tcfg


def weights(jcfg, tcfg, seed=0):
    jp, _ = unbox(jax_init_model(Init(jax.random.PRNGKey(seed),
                                      dtype=jcfg.jnp_dtype), jcfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")


@pytest.fixture(scope="module")
def fp32_pair():
    jcfg, tcfg = configs()
    jp, tp = weights(jcfg, tcfg)
    return jcfg, tcfg, jp, tp


def tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


LEAVES = ("k", "v", "k_scale", "v_scale")


def same_cache(tc, jc):
    for k in LEAVES:
        assert tuple(tc[k].shape) == jc[k].shape
        if k in ("k", "v"):
            assert tc[k].dtype == torch.int8
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            np.testing.assert_allclose(f32(tc[k]), f32(jc[k]), **F32)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_alloc_cache_int8_layout():
    _, tcfg = configs()
    c = alloc_cache(tcfg, 3, 40, torch.device("cpu"))
    L, KV, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim_
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert tuple(c["k"].shape) == (L, 3, 40, KV * hd)
    assert c["k_scale"].dtype == torch.float32
    assert tuple(c["v_scale"].shape) == (L, 3, 40, KV)
    assert not c["k_scale"].any()        # an empty slot's scale is 0


@pytest.mark.parametrize("with_true_lens", [False, True])
def test_prefill_logits_and_int8_cache_match_jax(fp32_pair, with_true_lens):
    jcfg, tcfg, jp, tp = fp32_pair
    toks = tokens(tcfg, 3, 16, seed=2)
    lens = np.asarray([16, 9, 3], np.int32)
    jkw = {"true_lens": jnp.asarray(lens)} if with_true_lens else {}
    tkw = {"true_lens": torch.from_numpy(lens)} if with_true_lens else {}
    jc, jl = jmodel.prefill_step(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 max_len=40, **jkw)
    tc, tl = tmodel.prefill_step(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                 max_len=40, **tkw)
    np.testing.assert_allclose(f32(tl), f32(jl), **F32)
    same_cache(tc, jc)
    # the ring's pad slots (16..39) hold zeros: scale 1.0, codes 0
    assert (tc["k_scale"][:, :, 16:] == 1.0).all() and not tc["k"][:, :, 16:].any()


@pytest.mark.parametrize("max_len", [40, 12])
def test_int8_decode_steps_match_jax(fp32_pair, max_len):
    """Six decode steps; max_len 12 wraps the ring."""
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
        same_cache(tc, jc)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


def test_decode_attend_returns_five_and_writes_in_place(fp32_pair):
    _, tcfg, _, tp = fp32_pair
    c = alloc_cache(tcfg, 2, 16, torch.device("cpu"))
    x = torch.randn(2, 1, tcfg.d_model, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([0, 17], dtype=torch.int32)
    leaves = [c[k][0] for k in LEAVES]
    res = tattn.decode_attend(tp["layers"][0]["attn"], tcfg, x, pos, *leaves)
    assert len(res) == 5 and all(a is b for a, b in zip(res[1:], leaves))
    assert c["k"][0, 0, 0].any() and c["k"][0, 1, 1].any()   # slots pos % C
    assert (c["k_scale"][0, 0, 0] > 0).all() and not c["k_scale"][0, 0, 1:].any()


def test_int8_kv_cache_close_to_fp_on_the_port():
    """tests/test_perf_features.py::test_int8_kv_cache_close_to_fp on the
    port (dcache-agent-150m.reduced(), the port's own weights): one decode
    step from an int8 cache against one from the fp cache, within 0.15."""
    _, cfg1 = configs()
    cfg0 = dataclasses.replace(cfg1, kv_quant=False)
    params = tmodel.init_model(cfg0, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(cfg0, 2, 12, seed=7))
    c0, l0 = tmodel.prefill_step(cfg0, params, {"tokens": toks}, max_len=16)
    c1, l1 = tmodel.prefill_step(cfg1, params, {"tokens": toks}, max_len=16)
    assert c1["k"].dtype == torch.int8 and "k_scale" in c1
    t = l0[:, -1].argmax(-1)[:, None].to(torch.int32)
    d0, _ = tmodel.decode_step(cfg0, params, t, c0)
    d1, _ = tmodel.decode_step(cfg1, params, t, c1)
    assert (d0 - d1).abs().max().item() < 0.15


def test_greedy_out_ids_match_jax_engine_int8():
    """The port's engine with kv_quant decodes the JAX engine's greedy
    tokens (fp32, CPU), as test_greedy_out_ids_match_jax_engine does for
    the fp cache."""
    jcfg, tcfg = configs(vocab_size=512)
    jp, tp = weights(jcfg, tcfg)
    prompts = ("alpha", "a much longer prompt about satellites", "geo")
    jeng = JaxServingEngine(jcfg, jp, max_batch=3, max_len=96)
    jreqs = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    jeng.run_until_done()
    teng = ServingEngine(tcfg, tp, max_batch=3, max_len=96, device="cpu")
    assert teng.cache["k"].dtype == torch.int8 and "v_scale" in teng.cache
    treqs = [teng.submit(p, max_new_tokens=6) for p in prompts]
    teng.run_until_done()
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert teng.steps == jeng.steps
