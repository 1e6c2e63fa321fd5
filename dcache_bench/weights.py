"""Seeded weights made on the device: the draw every architecture's
``make_params`` takes its leaves from.

Each kind of leaf is drawn for all layers at once into one tensor of the
served dtype (``normal_`` with a generator on the device, so there is no
float32 transient and nothing is made on the host); every layer's leaf is
a view of it. The same tensors go to the program and to the reference.

Scales keep activations near unit size at any depth: a product's weight
has std ``fan_in ** -0.5`` (the output projections of each block also
``n_layers ** -0.5``); the embedding (and the untied output head) has std
``d ** -0.5``, so logits of a unit-rms hidden state have std about 1; each
norm gain is ``1 + 0.1 N(0, 1)``, so a gain left out shows in the logits.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def drawer(seed: int, device, dtype: str) -> Callable[..., torch.Tensor]:
    """``draw(shape, std, mean=0.0)``: the next normal tensor of ``dtype``
    on ``device`` from one generator seeded with ``seed``, so the order of
    the calls fixes every leaf."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    dt = getattr(torch, dtype)

    def draw(shape: Tuple[int, ...], std: float, mean: float = 0.0) -> torch.Tensor:
        t = torch.empty(shape, dtype=dt, device=dev)
        return t.normal_(mean, std, generator=gen)
    return draw
