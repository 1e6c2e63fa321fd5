"""Token sampling: greedy / temperature / top-k (``repro.serving.sampler``).

Greedy is ``argmax`` with the first index on ties, as ``jnp.argmax``, and
matches the JAX sampler exactly. Temperature sampling draws from a
``torch.Generator`` and matches ``jax.random.categorical`` only in
distribution.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
           temperature: Union[float, Sequence[float]] = 0.0,
           top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) fp32 -> (B,) int32. ``temperature`` is one value for
    every row or one per row. A row at temperature <= 0 takes the argmax;
    the others draw from softmax(logits / t), over the ``top_k`` largest if
    ``top_k`` > 0. With no row above 0 nothing is drawn, so the generator
    advances only when some row samples."""
    temps = ([float(temperature)] * logits.shape[0]
             if isinstance(temperature, (int, float)) else list(temperature))
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all(t <= 0.0 for t in temps):
        return greedy
    t = torch.tensor([t if t > 0.0 else 1.0 for t in temps],
                     dtype=logits.dtype, device=logits.device)
    logits = logits / t[:, None]
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    drawn = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    hot = torch.tensor([t > 0.0 for t in temps], device=logits.device)
    return torch.where(hot, drawn, greedy)
