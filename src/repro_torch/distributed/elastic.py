"""Elastic scaling: lay a logically stored checkpoint out on a mesh
(``repro.distributed.elastic``).

Checkpoints (``repro_torch.distributed.checkpoint``) store every array at
its full logical shape, so ``reshard_tree`` re-derives each placement from
the same logical axes and rules on whatever mesh the run has; the
divisibility fallback of ``sharding.py`` keeps every spec valid on any mesh
shape. The port places onto a mesh of one device (one card): the spec is
derived and checked, and the tensor moves to that device whole. A mesh of
more devices raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import (map_axes, named_sharding,
                                              single_device)


def reshard_tree(values, axes_tree, mesh, rules: Dict):
    """Place a host-side tree (tensors or numpy arrays) onto ``mesh`` with
    rule-derived shardings; returns tensors on the mesh's device."""
    device = single_device(mesh)

    def place(ax, v):
        t = torch.as_tensor(v)
        named_sharding(ax, t.shape, mesh, rules)
        return t.to(device)

    return map_axes(place, axes_tree, values)


def mesh_transition_plan(old_shape: Dict[str, int],
                         new_shape: Dict[str, int]) -> Dict[str, str]:
    """Human-readable elastic transition summary (logged by the launcher)."""
    plan = {}
    for ax in sorted(set(old_shape) | set(new_shape)):
        o, n = old_shape.get(ax, 1), new_shape.get(ax, 1)
        if o == n:
            plan[ax] = f"keep {o}"
        elif n > o:
            plan[ax] = f"grow {o}->{n} (re-shard, {n // max(o,1)}x more slices)"
        else:
            plan[ax] = f"shrink {o}->{n} (gather + re-slice)"
    return plan
