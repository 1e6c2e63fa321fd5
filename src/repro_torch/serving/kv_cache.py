"""Paged KV cache (the port's copy of ``repro.serving.kv_cache``).

Physical storage is a pool of fixed-size pages per layer,
``(L, n_pages, page_size, kv_dim)``, on one device (``cuda`` unless asked
otherwise); each sequence owns a growable list of pages recorded in a page
table. ``gather`` copies a batch's pages into a contiguous view with one
``index_select`` per tensor, and ``paged_decode_attention`` runs the decode
attention kernel on that view. Compared with the engine's per-slot ring
buffers, paging removes the per-slot max-length reservation: memory scales
with the tokens in flight, not slots x max_len.

The allocator (free list, ref-counted pages for prefix sharing) is pure
Python and behaves as the reference's does, page for page.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class PagedCacheConfig:
    n_layers: int
    kv_dim: int                 # n_kv_heads * head_dim
    page_size: int = 16         # tokens per page
    n_pages: int = 256          # physical pages per layer
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class PageAllocator:
    """Host-side free-list allocator with ref counting (prefix sharing)."""

    def __init__(self, n_pages: int):
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refs: Dict[int, int] = {}

    def alloc(self) -> int:
        if not self.free:
            raise OutOfPages("no free KV pages")
        p = self.free.pop()
        self.refs[p] = 1
        return p

    def share(self, page: int):
        self.refs[page] += 1

    def release(self, page: int):
        self.refs[page] -= 1
        if self.refs[page] == 0:
            del self.refs[page]
            self.free.append(page)

    @property
    def n_free(self) -> int:
        return len(self.free)


@dataclasses.dataclass
class SequenceState:
    sid: int
    length: int = 0
    pages: List[int] = dataclasses.field(default_factory=list)


class PagedKVCache:
    """Paged K/V storage for all layers + per-sequence page tables. The
    writes update the storage in place (the JAX version replaces its
    arrays)."""

    def __init__(self, cfg: PagedCacheConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        shape = (cfg.n_layers, cfg.n_pages, cfg.page_size, cfg.kv_dim)
        self.k = torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device)
        self.alloc = PageAllocator(cfg.n_pages)
        self.seqs: Dict[int, SequenceState] = {}
        self._next_sid = 0

    # -- sequence lifecycle ---------------------------------------------------
    def new_seq(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        self.seqs[sid] = SequenceState(sid)
        return sid

    def free_seq(self, sid: int):
        for p in self.seqs[sid].pages:
            self.alloc.release(p)
        del self.seqs[sid]

    def fork_seq(self, sid: int) -> int:
        """Prefix sharing: a new sequence sharing all full pages (the last
        partial page is copied, not shared, so appends may diverge)."""
        src = self.seqs[sid]
        new = self.new_seq()
        dst = self.seqs[new]
        full = src.length // self.cfg.page_size
        for p in src.pages[:full]:
            self.alloc.share(p)
            dst.pages.append(p)
        dst.length = full * self.cfg.page_size
        if src.length > dst.length:  # copy the partial tail
            tail = src.pages[full]
            cp = self.alloc.alloc()
            self.k[:, cp] = self.k[:, tail]
            self.v[:, cp] = self.v[:, tail]
            dst.pages.append(cp)
            dst.length = src.length
        return new

    # -- write ------------------------------------------------------------
    def append(self, sid: int, k_tok: torch.Tensor, v_tok: torch.Tensor):
        """Append one token's K/V. k_tok/v_tok: (n_layers, kv_dim)."""
        s = self.seqs[sid]
        ps = self.cfg.page_size
        if s.length % ps == 0:
            s.pages.append(self.alloc.alloc())
        page = s.pages[-1]
        off = s.length % ps
        self.k[:, page, off] = k_tok
        self.v[:, page, off] = v_tok
        s.length += 1

    def write_prompt(self, sid: int, k_seq: torch.Tensor, v_seq: torch.Tensor):
        """Bulk prefill write. k_seq/v_seq: (n_layers, S, kv_dim)."""
        L, S, D = k_seq.shape
        s = self.seqs[sid]
        assert s.length == 0, "write_prompt on a non-empty sequence"
        ps = self.cfg.page_size
        n_pages = (S + ps - 1) // ps
        pad = n_pages * ps - S
        if pad:
            z = torch.zeros((L, pad, D), dtype=k_seq.dtype, device=k_seq.device)
            k_seq = torch.cat([k_seq, z], dim=1)
            v_seq = torch.cat([v_seq, z], dim=1)
        kp = k_seq.reshape(L, n_pages, ps, D)
        vp = v_seq.reshape(L, n_pages, ps, D)
        for i in range(n_pages):
            page = self.alloc.alloc()
            s.pages.append(page)
            self.k[:, page] = kp[:, i]
            self.v[:, page] = vp[:, i]
        s.length = S

    # -- read ------------------------------------------------------------
    def page_table(self, sids: List[int], max_pages: Optional[int] = None
                   ) -> np.ndarray:
        """(B, max_pages) int32 table, padded with page 0 (masked by len)."""
        mp = max_pages or max(len(self.seqs[s].pages) for s in sids)
        t = np.zeros((len(sids), mp), np.int32)
        for i, sid in enumerate(sids):
            pg = self.seqs[sid].pages
            t[i, :len(pg)] = pg
        return t

    def gather(self, sids: List[int]):
        """Contiguous (L, B, C, kv_dim) K and V via the page table, C =
        max_pages * page_size, and the lengths (B,) int32; positions beyond
        each sequence's length are junk and must be masked by the caller."""
        table = torch.from_numpy(self.page_table(sids)).to(self.device)
        B, P = table.shape
        L, _, ps, D = self.k.shape
        idx = table.reshape(-1).long()
        k = self.k.index_select(1, idx).reshape(L, B, P * ps, D)
        v = self.v.index_select(1, idx).reshape(L, B, P * ps, D)
        lengths = torch.tensor([self.seqs[s].length for s in sids],
                               dtype=torch.int32, device=self.device)
        return k, v, lengths

    # -- stats -------------------------------------------------------------
    def utilization(self) -> float:
        used = self.cfg.n_pages - self.alloc.n_free
        return used / self.cfg.n_pages


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, n_kv_heads: int,
                           head_dim: int) -> torch.Tensor:
    """Attention of one query token over gathered pages. q: (B, Hq*hd);
    k/v: (B, C, kv_dim); lengths: (B,). Returns (B, Hq*hd) in q's dtype.

    Runs ``ops.decode_attention`` on the gathered view with pos = lengths
    - 1: for 1 <= length <= C its ring mask (slot j holds position pos -
    ((pos - j) mod C), visible if >= 0) is exactly j < length."""
    B, C, _ = k.shape
    kc = k.reshape(B, C, n_kv_heads, head_dim).transpose(1, 2)
    vc = v.reshape(B, C, n_kv_heads, head_dim).transpose(1, 2)
    qh = q.reshape(B, -1, head_dim)
    pos = (lengths - 1).to(torch.int32)
    return ops.decode_attention(qh, kc, vc, pos).reshape(B, -1).to(q.dtype)
