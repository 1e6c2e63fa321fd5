"""Continuous-batching serving engine (``repro.serving.engine``).

A fixed decode batch of ``max_batch`` slots steps in lockstep (one
``decode_step`` per engine step, empty slots included); requests are
admitted into free slots by a single-row prefill whose cache row is copied
into the batch cache. Attention prompts are right-padded to a power-of-two
bucket (masked by construction, see ``prefill_step``); recurrent (ssm,
hybrid) prompts are prefilled at their exact length, since pad tokens would
pass through the recurrent state and the token shift. Completed rows free
their slot. Prefill and decode run under ``torch.no_grad()``, so trained
params that still require grad build no graph.

The engine serves text prompts. A vlm model serves them as the dense
decoder, with no patches, as the reference engine does. An encdec model
needs the encoder's frames at every prefill, which no request carries: the
engine refuses it at construction, and ``prefill_step``/``decode_step``
with ``frames`` are its entry points (the reference engine passes only
``tokens`` and fails at the first admission with ``KeyError: 'frames'``).

Two deviations from the reference engine, both repairs:

- A prompt whose bucket is longer than the ring (``effective_cache_len``,
  bounded by a sliding window or an attention chunk) is prefilled at its
  exact length too. Padded, ``pack_ring`` would keep the last C *padded*
  positions, and decode would read pad slots as in-window tokens while the
  true ones are gone (the reference's ``serving/engine.py:117-123`` with
  ``models/attention.py:162-164``).
- Decode samples each slot at its own ``Request.temperature``; the
  reference samples every decode token greedily (``serving/engine.py:149``).
  A batch of greedy slots still takes the argmax and draws nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import alloc_cache, effective_cache_len
from repro_torch.models.model import decode_step, prefill_step
from repro_torch.serving.sampler import sample
from repro_torch.serving.tokenizer import MIN_VOCAB, ByteTokenizer


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    out_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


def _bucket(n: int, cap: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


class ServingEngine:
    """Serves ``cfg`` with ``params`` on ``device`` (cuda unless asked for
    the CPU; raises when there is no CUDA and no explicit CPU request)."""

    def __init__(self, cfg: ModelConfig, params: Dict, *, max_batch: int = 4,
                 max_len: int = 512, tokenizer: Optional[ByteTokenizer] = None,
                 device=None):
        if cfg.vocab_size < MIN_VOCAB:
            raise ValueError("byte tokenizer needs vocab >= 258")
        if cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: an encoder-decoder model needs the encoder's "
                "frames at every prefill, and requests carry only text; "
                "serve it through repro_torch.models.model.prefill_step "
                "(batch with 'tokens' and 'frames') and decode_step")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.tok = tokenizer or ByteTokenizer()
        self.cache = alloc_cache(cfg, max_batch, max_len, self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.steps = 0
        self.prefills = 0

    # -- cache plumbing -------------------------------------------------------
    def _install(self, slot: int, row_cache: Dict):
        """Copy every leaf of a B=1 prefill cache (built with this engine's
        max_len, so a ring has the batch cache's length) into slot
        ``slot``: ``pos`` is (B,), the other leaves are layer-stacked
        (L, B, ...)."""
        self.cache["pos"][slot] = row_cache["pos"][0]
        for k, v in row_cache.items():
            if k != "pos":
                self.cache[k][:, slot] = v[:, 0]

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: str, max_new_tokens: int = 32,
               temperature: float = 0.0) -> Request:
        ids = self.tok.encode(prompt)[- (self.max_len // 2):]
        req = Request(rid=self._rid, prompt_ids=ids,
                      max_new_tokens=max_new_tokens, temperature=temperature,
                      submitted_at=time.perf_counter())
        self._rid += 1
        self.waiting.append(req)
        return req

    def _prefill_len(self, n: int) -> int:
        """The length a prompt of n tokens is prefilled at: its bucket, or n
        for a recurrent family (pad tokens would enter the state) and for a
        bucket longer than the ring (the padded tail would push true tokens
        out of it)."""
        bucket = _bucket(n, self.max_len)
        if self.cfg.family in ("ssm", "hybrid") \
                or bucket > effective_cache_len(self.cfg, self.max_len):
            return n
        return bucket

    @torch.no_grad()
    def _admit(self):
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            n = len(req.prompt_ids)
            bucket = self._prefill_len(n)
            tracing.record("engine.queue", req.submitted_at)
            with tracing.span("engine.admit", tokens=n, padded=bucket):
                ids = req.prompt_ids + [0] * (bucket - n)
                batch = {"tokens": torch.tensor([ids], dtype=torch.int32,
                                                device=self.device)}
                with tracing.span("model.prefill"):
                    row_cache, logits = prefill_step(
                        self.cfg, self.params, batch, max_len=self.max_len,
                        true_lens=torch.tensor([n], dtype=torch.int32,
                                               device=self.device))
                self.prefills += 1
                self._install(slot, row_cache)
                tok = sample(logits[:, -1].float(), self._gen,
                             temperature=req.temperature)
                with tracing.span("engine.sync"):
                    req.out_ids.append(int(tok[0]))
                req.first_token_at = time.perf_counter()
                self.slots[slot] = req

    @torch.no_grad()
    def step(self) -> int:
        """One engine step: admit waiting requests, decode all slots."""
        with tracing.span("engine.step") as st:
            prefills = self.prefills
            self._admit()
            active = [i for i, r in enumerate(self.slots) if r is not None]
            st.rows, st.admitted = len(active), self.prefills - prefills
            if not active:
                return 0
            tokens = np.zeros((self.max_batch, 1), np.int32)
            for i in active:
                tokens[i, 0] = self.slots[i].out_ids[-1]
            with tracing.span("model.decode"):
                logits, self.cache = decode_step(
                    self.cfg, self.params,
                    torch.from_numpy(tokens).to(self.device), self.cache)
            temps = [r.temperature if r is not None else 0.0 for r in self.slots]
            sampled = sample(logits[:, -1].float(), self._gen, temperature=temps)
            with tracing.span("engine.sync"):
                nxt = sampled.cpu().numpy()
            with tracing.span("engine.sync"):
                pos = self.cache["pos"].cpu().numpy()
            self.steps += 1
            for i in active:
                req = self.slots[i]
                tok = int(nxt[i])
                req.out_ids.append(tok)
                limit_hit = len(req.out_ids) >= req.max_new_tokens
                pos_cap = int(pos[i]) >= self.max_len - 1
                if tok == self.tok.eos_id or limit_hit or pos_cap:
                    req.done = True
                    req.finished_at = time.perf_counter()
                    self.finished.append(req)
                    self.slots[i] = None
            return len(active)

    def run_until_done(self, max_steps: int = 10_000):
        while (self.waiting or any(s is not None for s in self.slots)) \
                and max_steps > 0:
            self.step()
            max_steps -= 1

    def generate_text(self, prompt: str, max_new_tokens: int = 32,
                      temperature: float = 0.0) -> str:
        req = self.submit(prompt, max_new_tokens, temperature)
        self.run_until_done()
        return self.tok.decode(req.out_ids)

    # -- metrics ---------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        done = self.finished
        if not done:
            return {"finished": 0}
        ttft = [r.first_token_at - r.submitted_at for r in done
                if r.first_token_at]
        lat = [r.finished_at - r.submitted_at for r in done if r.finished_at]
        toks = sum(len(r.out_ids) for r in done)
        wall = max(r.finished_at for r in done) - min(
            r.submitted_at for r in done)
        return {"finished": len(done),
                "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
                "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
                "tokens": toks,
                "throughput_tok_s": toks / wall if wall > 0 else 0.0}
