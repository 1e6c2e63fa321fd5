"""Token sampling: greedy / temperature / top-k (``repro.serving.sampler``).

Greedy is ``argmax`` with the first index on ties, as ``jnp.argmax``, and
matches the JAX sampler exactly. Temperature sampling draws from a
``torch.Generator`` and matches ``jax.random.categorical`` only in
distribution.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) fp32 -> (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
