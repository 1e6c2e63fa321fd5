"""The system under test: ``repro_torch``'s serving engine, and nothing else.

This is the only module of the benchmark that imports the program. It
builds the port's ``ModelConfig`` from the plain fields an architecture
gives (``architectures/<name>.py``'s ``model_fields``) and the
``ServingEngine`` that the window drives through ``submit`` and ``step``,
the path by which ``TorchLLM`` serves every decision the agent makes.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import _build
from repro_torch.models import mlp_moe
from repro_torch.serving.engine import ServingEngine


def _build_dataclass(cls, fields: Dict):
    """``cls(**fields)``, with each dict value made into the dataclass that
    its field declares (``moe: Optional[MoEConfig]`` from a dict)."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for k, v in fields.items():
        if isinstance(v, dict):
            kinds = [t for t in (hints[k], *typing.get_args(hints[k]))
                     if dataclasses.is_dataclass(t)]
            if not kinds:
                raise TypeError(f"{cls.__name__}.{k} takes no dataclass")
            v = _build_dataclass(kinds[0], v)
        kw[k] = v
    return cls(**kw)


def model_config(fields: Dict) -> ModelConfig:
    return _build_dataclass(ModelConfig, fields)


def load_kernels() -> Optional[float]:
    """Build the kernel library into the checkout's ``build/kernels/`` (the
    first run of a checkout) or load it; nvcc's seconds where it built."""
    _build.build_log.pop("seconds", None)
    _build.load_library()
    return _build.build_log.get("seconds")


def engine(fields: Dict, sizes: Dict, params: Dict, device) -> ServingEngine:
    return ServingEngine(model_config(fields), params,
                         max_batch=sizes["max_batch"], max_len=sizes["max_len"],
                         device=device)


# the module whose ``moe`` the model calls for every expert layer; a traced
# run wraps that attribute in a host range (trace.py)
MOE_MODULE = mlp_moe
