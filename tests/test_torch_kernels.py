"""The port's plain kernel versions against the JAX Pallas kernels.

The Pallas kernels run as tests/test_kernels.py runs them (``repro.kernels.ops``,
interpret mode on the CPU), on the same numpy inputs. Ragged sizes the Pallas
kernels refuse (S % block != 0) go against ``repro.kernels.ref``. Tolerances
are those of tests/test_kernels.py: 3e-5 at fp32, 2e-2 at bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.rwkv_wkv import wkv_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def arrays(seed, *shapes, dtype="float32"):
    """The same seeded inputs as a JAX array and a torch tensor each."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = rng.normal(0, 1, shape).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=3e-5)


def close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol(dtype))


MASKS = {"causal": dict(causal=True), "window": dict(causal=True, window=64),
         "chunk": dict(causal=True, chunk=128), "full": dict(causal=False)}


@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 6, 2, 128, 32),
    (1, 4, 1, 512, 64),
])
@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_plain_vs_pallas(B, Hq, Hkv, S, d, mask):
    kw = MASKS[mask]
    (jq, tq), (jk, tk), (jv, tv) = arrays(1, (B, Hq, S, d), (B, Hkv, S, d),
                                          (B, Hkv, S, d))
    gold = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64, **kw)
    close(flash_attention_plain(tq, tk, tv, **kw), gold, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtypes(dtype):
    (jq, tq), (jk, tk), (jv, tv) = arrays(2, *([(1, 4, 128, 64)] * 3), dtype=dtype)
    gold = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    out = flash_attention_plain(tq, tk, tv)
    assert out.dtype == DTYPES[dtype][1]
    close(out, gold, dtype)


@pytest.mark.parametrize("S", [8, 9, 37])
@pytest.mark.parametrize("mask", ["causal", "window", "chunk"])
def test_flash_plain_ragged_vs_ref(S, mask):
    kw = {"causal": dict(causal=True), "window": dict(causal=True, window=5),
          "chunk": dict(causal=True, chunk=4)}[mask]
    (jq, tq), (jk, tk), (jv, tv) = arrays(3, (1, 12, S, 64), (1, 4, S, 64),
                                          (1, 4, S, 64))
    gold = jref.ref_flash_attention(jq, jk, jv, **kw)
    close(flash_attention_plain(tq, tk, tv, **kw), gold, "float32")


def _pos(seed, B, C):
    return np.random.default_rng(seed).integers(1, 3 * C, B).astype(np.int32)


@pytest.mark.parametrize("B,Hq,Hkv,C,d", [
    (2, 4, 2, 256, 64), (3, 8, 8, 128, 32), (1, 16, 2, 512, 128),
])
@pytest.mark.parametrize("mask", ["none", "window", "chunk"])
def test_decode_plain_vs_pallas(B, Hq, Hkv, C, d, mask):
    kw = {"none": {}, "window": dict(window=64), "chunk": dict(chunk=128)}[mask]
    (jq, tq), (jk, tk), (jv, tv) = arrays(4, (B, Hq, d), (B, Hkv, C, d),
                                          (B, Hkv, C, d))
    pos = _pos(5, B, C)
    gold = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=64, **kw)
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(pos), **kw)
    close(out, gold, "float32")


@pytest.mark.parametrize("pos", [[3, 17], [63, 63], [130, 200], [0, 1]])
def test_decode_plain_ring_positions(pos):
    """pos < C (unwritten slots masked), pos = C-1, pos > 2C, pos = 0."""
    B, Hq, Hkv, C, d = 2, 12, 4, 64, 64
    (jq, tq), (jk, tk), (jv, tv) = arrays(6, (B, Hq, d), (B, Hkv, C, d),
                                          (B, Hkv, C, d))
    p = np.asarray(pos, np.int32)
    gold = jops.decode_attention(jq, jk, jv, jnp.asarray(p), block_k=64)
    close(decode_attention_plain(tq, tk, tv, torch.from_numpy(p)), gold,
          "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_dtypes(dtype):
    (jq, tq), (jk, tk), (jv, tv) = arrays(7, (4, 12, 64), (4, 4, 128, 64),
                                          (4, 4, 128, 64), dtype=dtype)
    pos = np.asarray([5, 127, 300, 64], np.int32)
    gold = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=64,
                                 window=100)
    out = decode_attention_plain(tq, tk, tv, torch.from_numpy(pos), window=100)
    close(out, gold, dtype)


@pytest.mark.parametrize("shape", [(8, 256), (2, 5, 128), (3, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_vs_pallas(shape, dtype):
    (jx, tx), (jg, tg) = arrays(8, shape, (shape[-1],), dtype=dtype)
    gold = jops.rmsnorm(jx, jg)
    out = rmsnorm_plain(tx, tg)
    assert out.dtype == DTYPES[dtype][1]
    close(out, gold, dtype)


@pytest.mark.parametrize("rows,d", [(1, 768), (4, 768), (257, 768), (257, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_ragged_vs_ref(rows, d, dtype):
    (jx, tx), (jg, tg) = arrays(9, (rows, d), (d,), dtype=dtype)
    close(rmsnorm_plain(tx, tg), jref.ref_rmsnorm(jx, jg), dtype)


def test_wrappers_on_cpu_take_plain_and_count_nothing():
    tops.reset_launch_counts()
    (_, tq), (_, tk), (_, tv) = arrays(10, (1, 4, 16, 32), (1, 2, 16, 32),
                                       (1, 2, 16, 32))
    assert torch.equal(tops.flash_attention(tq, tk, tv),
                       flash_attention_plain(tq, tk, tv))
    q1, kc = tq[:, :, 0], tk
    pos = torch.tensor([20], dtype=torch.int32)
    assert torch.equal(tops.decode_attention(q1, kc, tv, pos),
                       decode_attention_plain(q1, kc, tv, pos))
    g = torch.ones(32)
    assert torch.equal(tops.rmsnorm(tq, g), rmsnorm_plain(tq, g))
    r, k, v = tq, tk.repeat(1, 2, 1, 1), tv.repeat(1, 2, 1, 1)
    w, u = torch.full_like(r, 0.9), torch.ones((16, 32))
    y, s = tops.wkv(r, k, v, w, u)
    y_ref, s_ref = wkv_plain(r, k, v, w, u)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    assert tops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0,
                                    "decode_attention": 0, "wkv": 0}


def test_wrappers_refuse_other_devices():
    x = torch.empty((2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.rmsnorm(x, torch.empty((64,), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tops.rmsnorm(torch.ones(2, 64), torch.empty((64,), device="meta"))
