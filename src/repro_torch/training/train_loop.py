"""Training loop (``repro.training.train_loop``): the train step (loss ->
grads -> AdamW) with optional gradient accumulation, checkpoint/restore
hooks and a supervisor that retries a failed step.

Checkpoints hold the JAX package's tree, ``{"params", "opt_state": {"mu",
"nu", "step"}, "meta": {"step"}}`` with layer-stacked leaves
(``bridge.to_jax_layout``), so a file this loop writes is one the
reference's ``TrainLoop`` restores, and the other way round.

The step runs eagerly. It differentiates ``loss_fn``, whose forward takes
the training route on any device (no hand-written kernel: they have no
backward). Parameters outside a step are plain leaf tensors with
``requires_grad=False``, so the serving engine takes them as they are.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.bridge import from_jax_layout, param_shapes, to_jax_layout
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.fault_tolerance import WorkerFailure
from repro_torch.models.model import loss_fn
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, tree_leaves,
                                            tree_map, tree_unflatten)


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """(grads, metrics): the gradient of ``loss_fn``'s total with respect
    to every leaf of params (a tree like params), and its detached metrics,
    as JAX's ``value_and_grad(..., has_aux=True)``. A leaf the loss does not
    use (rwkv6's ``mu_x``, as in JAX) gets zeros."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, metrics = loss_fn(cfg, p, batch)
        grads = torch.autograd.grad(total, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
    return (tree_unflatten(params, grads),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    With ``accum_steps > 1`` the batch's leading dim is split into
    microbatches, their gradients are summed into fp32 zeros and divided by
    ``accum_steps``, and the metrics are the last microbatch's."""

    def step(params, opt_state, batch):
        if accum_steps == 1:
            grads, metrics = loss_and_grads(cfg, params, batch)
        else:
            mbs = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                + v.shape[1:]) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(accum_steps):
                g, metrics = loss_and_grads(
                    cfg, params, {k: v[i] for k, v in mbs.items()})
                grads = tree_map(torch.add, grads, g)
            grads = tree_map(lambda g: g / accum_steps, grads)
        params, opt_state, opt_m = adamw_update(opt_cfg, params, grads,
                                                opt_state)
        metrics.update(opt_m)
        return params, opt_state, metrics

    return step


class TrainLoop:
    """Step executor with checkpointing and failure recovery.

    ``failure_injector`` (tests) may raise ``WorkerFailure`` inside a step;
    the loop restores the last checkpoint, if a ``checkpointer`` has one,
    and repeats the step, at most ``max_retries`` times. Batches come from
    ``data_iter`` as numpy arrays and go to the params' device; float
    entries are cast to bf16 for a bf16 model.
    """

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, params,
                 data_iter, checkpointer=None, ckpt_every: int = 50,
                 accum_steps: int = 1, monitor=None,
                 failure_injector: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.step_fn = make_train_step(cfg, opt_cfg, accum_steps)
        self.params = params
        self.opt_state = init_opt_state(params)
        self.device = tree_leaves(params)[0].device
        self.data = data_iter
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.monitor = monitor
        self.failure_injector = failure_injector
        self.step_idx = 0
        self.history: list = []

    def _ckpt_tree(self) -> Dict[str, Any]:
        """The checkpoint's tree, in the JAX layout."""
        o = self.opt_state
        return {"params": to_jax_layout(self.params, self.cfg),
                "opt_state": {"step": o["step"],
                              "mu": to_jax_layout(o["mu"], self.cfg),
                              "nu": to_jax_layout(o["nu"], self.cfg)},
                "meta": {"step": self.step_idx}}

    def _ckpt_like(self) -> Dict[str, Any]:
        """The checkpoint tree's structure, from the config alone (restore
        reads only its paths)."""
        def struct(tree):
            return {k: struct(v) if isinstance(v, dict) else 0
                    for k, v in tree.items()}
        p = struct(param_shapes(self.cfg))
        return {"params": p, "opt_state": {"step": 0, "mu": p, "nu": p},
                "meta": {"step": 0}}

    def restore_if_available(self) -> bool:
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore_latest(like=self._ckpt_like())
        if restored is None:
            return False
        as_like = lambda p, r: torch.as_tensor(  # noqa: E731
            r, device=p.device).to(p.dtype)
        port = lambda t: from_jax_layout(t, self.cfg)  # noqa: E731
        ro = restored["opt_state"]
        self.params = tree_map(as_like, self.params, port(restored["params"]))
        self.opt_state = tree_map(as_like, self.opt_state,
                                  {"step": ro["step"], "mu": port(ro["mu"]),
                                   "nu": port(ro["nu"])})
        self.step_idx = int(restored["meta"]["step"])
        return True

    def _checkpoint(self):
        if self.ckpt is not None:
            self.ckpt.save(self.step_idx, self._ckpt_tree())

    def run(self, n_steps: int, max_retries: int = 3) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {}
        while self.step_idx < n_steps:
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in next(self.data).items()}
            if self.cfg.torch_dtype == torch.bfloat16:
                batch = {k: (v.to(torch.bfloat16)
                             if v.dtype == torch.float32 else v)
                         for k, v in batch.items()}
            attempts = 0
            while True:
                t0 = time.perf_counter()
                try:
                    if self.failure_injector is not None:
                        self.failure_injector(self.step_idx)
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, batch)
                    loss = float(metrics["loss"])   # waits for the device
                    break
                except WorkerFailure:
                    attempts += 1
                    if attempts > max_retries:
                        raise
                    restored = self.restore_if_available()
                    if self.monitor:
                        self.monitor.record_failure(self.step_idx, restored)
            dt = time.perf_counter() - t0
            if self.monitor:
                self.monitor.record_step(self.step_idx, dt)
            self.history.append(loss)
            self.step_idx += 1
            if self.ckpt_every and self.step_idx % self.ckpt_every == 0:
                self._checkpoint()
        self._checkpoint()
        return {k: float(v) for k, v in metrics.items()}
