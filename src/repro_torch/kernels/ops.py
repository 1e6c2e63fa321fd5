"""Dispatch layer for the port's kernels (counterpart of ``repro.kernels.ops``).

A tensor on the CPU takes the kernel's plain PyTorch version; a tensor on a
CUDA device launches the hand-written Hopper kernel, or the wrapper raises.
There is no fallback from the card to the plain version. No kernel has a
backward, so a CUDA input that requires grad under grad mode raises
(training takes ``forward(..., is_train=True)``).
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_int8)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rope import rope, rope_append
from repro_torch.kernels.rwkv_wkv import wkv

__all__ = ["rmsnorm", "flash_attention", "decode_attention",
           "decode_attention_int8", "mla_decode", "wkv", "rope", "rope_append"]
