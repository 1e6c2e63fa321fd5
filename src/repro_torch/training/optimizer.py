"""AdamW with a cosine schedule (``repro.training.optimizer``).

Parameters are the model's nested dicts and lists of tensors; ``tree_map``
and ``tree_leaves`` walk them. The moments are fp32 whatever the params'
dtype, with the params' shapes and device. ``adamw_update`` returns new
tensors and changes none of its inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of ``tree`` and of ``rest`` (same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` in its leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine decay to ``min_lr_frac`` of lr (fp32)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def init_opt_state(params) -> Dict[str, Any]:
    """int32 ``step`` 0 and fp32 zero moments ``mu``/``nu`` like params."""
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                    device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
            "mu": tree_map(zeros32, params),
            "nu": tree_map(zeros32, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (new_params, new_opt_state, {"lr", "grad_norm"}), in JAX's
    order: clip by the global norm (+1e-9), the moments, bias correction
    by b ** step, decoupled decay on the fp32 param, the update in fp32
    cast back to the param's dtype."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    stepf = step.to(torch.float32)
    c1, c2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = [upd(p, g, m, n) for p, g, m, n in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["mu"]),
        tree_leaves(opt_state["nu"]))]
    new_p, new_mu, new_nu = (tree_unflatten(params, [o[i] for o in out])
                             for i in range(3))
    return new_p, {"step": step, "mu": new_mu, "nu": new_nu}, \
        {"lr": lr, "grad_norm": gnorm}
