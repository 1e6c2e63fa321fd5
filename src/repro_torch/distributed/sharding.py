"""Logical-axis sharding rules with the divisibility fallback
(``repro.distributed.sharding``).

Every parameter and activation dimension carries a logical name; ``rules``
map names to mesh axes. An assignment whose dimension does not divide by
the mesh axes' extent falls back to the longest prefix of those axes that
divides it, else to replication, and a mesh axis appears at most once in
a spec. These are pure functions over any mesh with a ``.shape`` mapping
of axis name to size, as the reference's are, so specs derive for the
production meshes (16x16, 2x16x16) with no device present.

The port places tensors on a mesh of one device only (``elastic.
reshard_tree``); ``sharding_context`` and ``constrain`` are the identity
there and raise on a mesh of more devices, which the port does not run.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import (Dict, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

Axes = Tuple[str, ...]  # logical axis names, one per tensor dim ("" = none)
Rule = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis or a tuple of them."""

    def __new__(cls, *entries: Rule):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named mesh axes and their sizes, with the devices that hold them:
    ``devices`` None for a logical mesh, on which specs derive but nothing
    is placed."""

    def __init__(self, shape: Mapping[str, int],
                 devices: Optional[Sequence[torch.device]] = None):
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.devices = None if devices is None else list(devices)
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} devices, "
                             f"got {len(self.devices)}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices})"


class NamedSharding(NamedTuple):
    mesh: Mesh
    spec: PartitionSpec


def single_device(mesh) -> torch.device:
    """The one device of ``mesh``; NotImplementedError for a mesh of more
    devices or a logical one (the port runs on one card)."""
    devices = getattr(mesh, "devices", None)
    if devices is None or len(devices) != 1:
        raise NotImplementedError(
            f"placing onto mesh {dict(mesh.shape)} needs more than one device "
            "or none; the port places onto a mesh of one device only")
    return devices[0]


# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------

def single_pod_rules() -> Dict[str, Rule]:
    return {
        # weights
        "vocab": "model",
        "embed": "data",        # FSDP axis
        "mlp": "model",         # tensor parallel
        "heads": "model",       # flattened n_heads*head_dim
        "kv": "model",          # flattened n_kv_heads*head_dim
        "experts": None,
        "layers": None,
        "lora": None,
        "ssm_dim": "model",     # flattened ssm_heads*head_dim
        "ssm_state": None,
        "conv": None,
        # activations
        "batch": "data",
        "seq": None,
        "act_embed": None,
        "act_mlp": "model",
        "act_heads": "model",
        "act_kv": "model",
        "cache_seq": None,
        # MoE dispatch buffers (G,E,C,D): token-group dim in baseline
        "moe_tokens": "data",
    }


def multi_pod_rules() -> Dict[str, Rule]:
    r = single_pod_rules()
    # FSDP over all 512 chips; data parallel batch over pod x data
    r["embed"] = ("pod", "data")
    r["batch"] = ("pod", "data")
    r["moe_tokens"] = ("pod", "data")
    return r


def expert_parallel_rules(base: Dict[str, Rule]) -> Dict[str, Rule]:
    """Expert parallelism: expert weights shard over the FSDP axis instead
    of being replicated, and the dispatch buffers switch from
    token-sharded to expert-sharded. Expert weights are (layers, experts,
    embed, mlp): "experts" precedes "embed", so the one-axis-per-spec rule
    drops the FSDP axis from their embed dim only."""
    r = dict(base)
    r["experts"] = base["embed"]   # E takes over the FSDP axis
    r["moe_tokens"] = None
    return r


def serve_rules(base: Dict[str, Rule]) -> Dict[str, Rule]:
    """Decode-time layout: pure tensor parallelism for the dense weights
    (replicated over data) plus expert parallelism for MoE weights."""
    r = expert_parallel_rules(base)
    r["embed"] = None          # dense weights: replicate over data, TP on model
    return r


# ---------------------------------------------------------------------------
# Spec derivation
# ---------------------------------------------------------------------------

def _axis_entry(dim: int, rule: Rule, mesh) -> Rule:
    """Mesh assignment for one dim, dropping it if not divisible."""
    if rule is None:
        return None
    names = (rule,) if isinstance(rule, str) else tuple(rule)
    names = tuple(n for n in names if n in mesh.shape)
    if not names:
        return None
    size = 1
    for n in names:
        size *= mesh.shape[n]
    if dim % size != 0:
        # try progressively shorter prefixes before replicating
        for k in range(len(names) - 1, 0, -1):
            sz = 1
            for n in names[:k]:
                sz *= mesh.shape[n]
            if dim % sz == 0:
                return names[:k] if k > 1 else names[0]
        return None
    return names if len(names) > 1 else names[0]


def logical_to_spec(axes: Axes, shape: Sequence[int], mesh,
                    rules: Dict[str, Rule]) -> PartitionSpec:
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != shape {tuple(shape)} rank")
    entries, used = [], set()
    for dim, name in zip(shape, axes):
        e = _axis_entry(dim, rules.get(name), mesh) if name else None
        # a mesh axis may appear at most once in a PartitionSpec
        if e is not None:
            flat = (e,) if isinstance(e, str) else e
            if any(f in used for f in flat):
                e = None
            else:
                used.update(flat)
        entries.append(e)
    return PartitionSpec(*entries)


def named_sharding(axes: Axes, shape: Sequence[int], mesh,
                   rules: Dict[str, Rule]) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, shape, mesh, rules))


def is_axes(x) -> bool:
    """An axes leaf: a tuple of str (the empty tuple for a scalar)."""
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def map_axes(fn, axes_tree, other):
    """fn(axes, o) over the axes leaves of ``axes_tree`` and the matching
    nodes of ``other`` (a tree of the same dicts and lists)."""
    if is_axes(axes_tree):
        return fn(axes_tree, other)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, v, other[k]) for k, v in axes_tree.items()}
    return [map_axes(fn, v, o) for v, o in zip(axes_tree, other)]


def _shape(s) -> Tuple[int, ...]:
    return tuple(s.shape) if hasattr(s, "shape") else tuple(s)


def tree_shardings(axes_tree, shape_tree, mesh, rules: Dict[str, Rule]):
    """(axes tree, tree of shapes or of objects with ``.shape``) ->
    NamedSharding tree."""
    return map_axes(lambda ax, s: named_sharding(ax, _shape(s), mesh, rules),
                    axes_tree, shape_tree)


# ---------------------------------------------------------------------------
# Activation-constraint context (no-op outside a mesh context)
# ---------------------------------------------------------------------------

class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[Dict[str, Rule]] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_context(mesh, rules: Dict[str, Rule]):
    """Make ``mesh`` and ``rules`` the ones ``constrain`` reads. Only a
    mesh of one device is accepted."""
    single_device(mesh)
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def constrain(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` under the active
    context: on a mesh of one device the spec is derived (its rank is
    checked) and x is returned as it is; identity outside a context."""
    if _CTX.mesh is None:
        return x
    logical_to_spec(axes, x.shape, _CTX.mesh, _CTX.rules)
    return x
