"""The port's int8 gradient compression against the JAX package's, and
tests/test_training.py's compression mirrors. Codes and scales must be
equal (JAX's eager ``compress`` divides by the fp32 scale and rounds half to
even, as the port does); ``compressed_psum`` runs over a one-rank gloo
group started from a FileStore.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.training import grad_compress as jgc
from repro_torch.training import grad_compress as tgc


def grads(seed, shape, scale=0.1):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(1000,), (256,), (3, 300), (7, 5, 11)])
def test_compress_matches_jax(shape):
    g = grads(0, shape)
    g.reshape(-1)[:256] = 0.0                       # one all-zero block
    codes, scale = tgc.compress(torch.from_numpy(g))
    jcodes, jscale = jgc.compress(jnp.asarray(g))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert scale[0, 0] == 1.0                        # zero block: scale 1
    back = tgc.decompress(codes, scale, shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jgc.decompress(jcodes, jscale, shape)))


def test_round_half_to_even():
    g = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])   # scale 1.0
    codes, scale = tgc.compress(g)
    assert float(scale[0, 0]) == 1.0
    assert codes[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_bf16_input_and_output_dtype():
    g = torch.from_numpy(grads(2, (300,))).to(torch.bfloat16)
    codes, scale = tgc.compress(g)
    jcodes, jscale = jgc.compress(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    out = tgc.decompress(codes, scale, g.shape, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == g.shape


def test_compress_with_feedback_matches_jax():
    g, res = grads(3, (600,)), grads(4, (600,), 0.01)
    codes, scale, r2 = tgc.compress_with_feedback(torch.from_numpy(g),
                                                  torch.from_numpy(res))
    jcodes, jscale, jr2 = jgc.compress_with_feedback(jnp.asarray(g), jnp.asarray(res))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), atol=1e-7, rtol=0)


def test_compress_roundtrip_error_bounded():
    g = torch.from_numpy(grads(0, (1000,)))
    codes, scale = tgc.compress(g)
    assert codes.dtype == torch.int8
    err = (tgc.decompress(codes, scale, g.shape) - g).abs()
    assert err.max() <= g.abs().max() / 127 + 1e-6


def test_error_feedback_accumulates_lost_mass():
    g = torch.from_numpy(grads(1, (512,)))
    res = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(30):
        codes, scale, res = tgc.compress_with_feedback(g, res)
        total = total + tgc.decompress(codes, scale, g.shape)
    np.testing.assert_allclose((total / 30).numpy(), g.numpy(), atol=2e-3)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_psum_single_rank(one_rank_group):
    g = torch.linspace(-1, 1, 256)
    out = tgc.compressed_psum(g)
    np.testing.assert_allclose(out.numpy(), g.numpy(), atol=2e-2)
    codes, scale = tgc.compress(g)
    assert torch.equal(out, tgc.decompress(codes, scale, g.shape))
    allreduce = tgc.make_compressed_allreduce()
    g2 = torch.from_numpy(grads(5, (3, 100)))
    assert torch.equal(allreduce(g2), tgc.compressed_psum(g2))
    assert allreduce(g2).shape == (3, 100)
