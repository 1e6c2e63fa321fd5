"""The port's paged KV cache against the JAX package's.

The seven tests of tests/test_paged_kv.py on the port (CPU, fp32), a
parity test that drives both caches through the same calls and compares
their allocator state and ``gather`` exactly, and ``paged_decode_attention``
against JAX's within 2e-5 (fp32), zero-length rows included. On the CPU the
port's paged attention is ``decode_attention_plain`` on the gathered view
with pos = lengths - 1; on the card it is the Hopper decode kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kv_cache as jkv
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.serving.kv_cache import (OutOfPages, PagedCacheConfig,
                                          PagedKVCache, paged_decode_attention)

RNG = np.random.default_rng(0)


def mk(n_pages=32, page_size=4, L=2, kvd=16, dtype="float32"):
    return PagedKVCache(PagedCacheConfig(
        n_layers=L, kv_dim=kvd, page_size=page_size, n_pages=n_pages,
        dtype=dtype), device="cpu")


def rand(*s):
    return torch.from_numpy(RNG.normal(size=s).astype(np.float32))


# ---------------------------------------------------------------------------
# tests/test_paged_kv.py on the port
# ---------------------------------------------------------------------------

def test_append_and_gather_roundtrip():
    c = mk()
    sid = c.new_seq()
    toks = [rand(2, 16) for _ in range(6)]
    for t in toks:
        c.append(sid, t, t * 2)
    k, v, lens = c.gather([sid])
    assert int(lens[0]) == 6 and lens.dtype == torch.int32
    for i, t in enumerate(toks):
        np.testing.assert_allclose(k[:, 0, i].numpy(), t.numpy())
        np.testing.assert_allclose(v[:, 0, i].numpy(), t.numpy() * 2)


def test_write_prompt_matches_appends():
    c1, c2 = mk(), mk()
    kseq, vseq = rand(2, 7, 16), rand(2, 7, 16)
    s1 = c1.new_seq()
    c1.write_prompt(s1, kseq, vseq)
    s2 = c2.new_seq()
    for i in range(7):
        c2.append(s2, kseq[:, i], vseq[:, i])
    k1, _, _ = c1.gather([s1])
    k2, _, _ = c2.gather([s2])
    np.testing.assert_allclose(k1[:, :, :7].numpy(), k2[:, :, :7].numpy())


def test_memory_scales_with_tokens_not_slots():
    c = mk(n_pages=32, page_size=4)
    sids = [c.new_seq() for _ in range(4)]
    for sid in sids:
        for _ in range(3):                       # 3 tokens -> 1 page each
            t = rand(2, 16)
            c.append(sid, t, t)
    assert c.alloc.n_free == 32 - 4              # no max-len reservation
    assert c.utilization() == 4 / 32


def test_out_of_pages_raises():
    c = mk(n_pages=2, page_size=2)
    sid = c.new_seq()
    t = rand(2, 16)
    for _ in range(4):
        c.append(sid, t, t)
    with pytest.raises(OutOfPages):
        c.append(sid, t, t)


def test_free_seq_releases_pages():
    c = mk(n_pages=8, page_size=2)
    sid = c.new_seq()
    t = rand(2, 16)
    for _ in range(5):
        c.append(sid, t, t)
    assert c.alloc.n_free == 8 - 3
    c.free_seq(sid)
    assert c.alloc.n_free == 8


def test_prefix_sharing_fork():
    c = mk(n_pages=16, page_size=4)
    a = c.new_seq()
    toks = [rand(2, 16) for _ in range(10)]     # 2 full pages + partial
    for t in toks:
        c.append(a, t, t)
    used_before = 16 - c.alloc.n_free
    b = c.fork_seq(a)
    # shared full pages + 1 copied partial page
    assert (16 - c.alloc.n_free) == used_before + 1
    kb, _, lens = c.gather([b])
    assert int(lens[0]) == 10
    for i, t in enumerate(toks):
        np.testing.assert_allclose(kb[:, 0, i].numpy(), t.numpy())
    # divergence: appending to the fork must not disturb the parent
    c.append(b, rand(2, 16), rand(2, 16))
    ka, _, _ = c.gather([a])
    np.testing.assert_allclose(ka[:, 0, 9].numpy(), toks[9].numpy())


def test_paged_attention_matches_contiguous():
    c = mk(n_pages=64, page_size=4, L=1, kvd=32)   # 2 kv heads x 16
    sids = []
    lens = [5, 9, 3]
    store = {}
    for n in lens:
        sid = c.new_seq()
        ks, vs = rand(1, n, 32), rand(1, n, 32)
        c.write_prompt(sid, ks, vs)
        store[sid] = (ks, vs)
        sids.append(sid)
    k, v, lengths = c.gather(sids)
    q = rand(3, 64)                                # 4 q heads x 16
    out = paged_decode_attention(q, k[0], v[0], lengths,
                                 n_kv_heads=2, head_dim=16)
    # contiguous reference per sequence
    for i, sid in enumerate(sids):
        ks, vs = store[sid]
        kc = ks[0].reshape(lens[i], 2, 16)
        vc = vs[0].reshape(lens[i], 2, 16)
        qh = q[i].reshape(2, 2, 16)
        s = torch.einsum("kgh,tkh->kgt", qh, kc) * (16 ** -0.5)
        w = torch.softmax(s, dim=-1)
        ref = torch.einsum("kgt,tkh->kgh", w, vc).reshape(-1)
        np.testing.assert_allclose(out[i].numpy(), ref.numpy(),
                                   atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the port against the JAX cache
# ---------------------------------------------------------------------------

def _both(n_pages, page_size, L, kvd):
    cfg = dict(n_layers=L, kv_dim=kvd, page_size=page_size, n_pages=n_pages,
               dtype="float32")
    return (jkv.PagedKVCache(jkv.PagedCacheConfig(**cfg)),
            PagedKVCache(PagedCacheConfig(**cfg), device="cpu"))


def _same_state(jc, tc, sids):
    assert tc.alloc.free == jc.alloc.free
    assert tc.alloc.refs == jc.alloc.refs
    assert {s: (q.length, q.pages) for s, q in tc.seqs.items()} == \
        {s: (q.length, q.pages) for s, q in jc.seqs.items()}
    np.testing.assert_array_equal(tc.page_table(sids), jc.page_table(sids))
    jk, jv, jl = jc.gather(sids)
    tk, tv, tl = tc.gather(sids)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tc.utilization() == jc.utilization()


def test_allocator_and_gather_match_jax():
    """The same calls of new_seq, write_prompt, append, fork_seq and
    free_seq on both caches: equal free lists, ref counts, page tables and
    gathered K/V."""
    jc, tc = _both(n_pages=24, page_size=4, L=2, kvd=16)
    rng = np.random.default_rng(1)

    def tok():
        a, b = (rng.normal(size=(2, 16)).astype(np.float32) for _ in range(2))
        return a, b

    def both_call(name, *args):
        jr = getattr(jc, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args])
        tr = getattr(tc, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                                 else a for a in args])
        assert jr == tr
        return tr

    a = both_call("new_seq")
    both_call("write_prompt", a, *(rng.normal(size=(2, 10, 16)).astype(np.float32)
                                  for _ in range(2)))
    b = both_call("new_seq")
    for _ in range(5):
        both_call("append", b, *tok())
    _same_state(jc, tc, [a, b])
    f = both_call("fork_seq", a)                 # 2 shared pages + a copied tail
    both_call("append", f, *tok())
    g = both_call("fork_seq", b)                 # 1 shared page + a copied tail
    _same_state(jc, tc, [a, b, f, g])
    both_call("free_seq", a)
    for _ in range(7):
        both_call("append", g, *tok())
    c = both_call("new_seq")
    both_call("write_prompt", c, *(rng.normal(size=(2, 4, 16)).astype(np.float32)
                                  for _ in range(2)))
    _same_state(jc, tc, [b, f, g, c])
    both_call("free_seq", f)
    _same_state(jc, tc, [b, g, c])


@pytest.mark.parametrize("lens", [[5, 9, 3], [0, 1, 16, 17], [33, 0, 2]])
def test_paged_decode_attention_matches_jax(lens):
    """fp32 within 2e-5, zero-length rows included (both sides then
    return the mean of the gathered V)."""
    jc, tc = _both(n_pages=64, page_size=4, L=1, kvd=128)   # 2 kv heads x 64
    rng = np.random.default_rng(2)
    sids = []
    for n in lens:
        sid = jc.new_seq()
        assert tc.new_seq() == sid
        if n:
            ks, vs = (rng.normal(size=(1, n, 128)).astype(np.float32)
                      for _ in range(2))
            jc.write_prompt(sid, jnp.asarray(ks), jnp.asarray(vs))
            tc.write_prompt(sid, torch.from_numpy(ks), torch.from_numpy(vs))
        sids.append(sid)
    jk, jv, jl = jc.gather(sids)
    tk, tv, tl = tc.gather(sids)
    q = rng.normal(size=(len(lens), 6 * 64)).astype(np.float32)  # G = 3
    want = jkv.paged_decode_attention(jnp.asarray(q), jk[0], jv[0], jl, 2, 64)
    out = paged_decode_attention(torch.from_numpy(q), tk[0], tv[0], tl, 2, 64)
    assert out.shape == (len(lens), 6 * 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_paged_attention_is_the_decode_kernel_on_the_gathered_view(no_library):
    """paged_decode_attention is decode_attention (here its plain version)
    with pos = lengths - 1 on the (B, KV, C, hd) view of the gathered
    pages, and never reaches the kernel library on the CPU."""
    c = mk(n_pages=64, page_size=16, L=1, kvd=256)   # 4 kv heads x 64
    sids = []
    for n in (1, 15, 16, 17, 40):
        sid = c.new_seq()
        c.write_prompt(sid, rand(1, n, 256), rand(1, n, 256))
        sids.append(sid)
    k, v, lengths = c.gather(sids)
    q = rand(5, 12 * 64)
    out = paged_decode_attention(q, k[0], v[0], lengths, 4, 64)
    B, C = 5, k.shape[2]
    ref = decode_attention_plain(
        q.view(B, 12, 64), k[0].view(B, C, 4, 64).transpose(1, 2),
        v[0].view(B, C, 4, 64).transpose(1, 2), (lengths - 1).to(torch.int32))
    assert torch.equal(out, ref.reshape(B, -1))


def test_paged_cache_dtype_and_device():
    c = mk(dtype="bfloat16")
    assert c.k.dtype == c.v.dtype == torch.bfloat16
    assert c.k.device.type == "cpu" and tuple(c.k.shape) == (2, 32, 4, 16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PagedKVCache(PagedCacheConfig(n_layers=1, kv_dim=16))
