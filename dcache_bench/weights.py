"""Seeded weights made on the device, in the layout ``ServingEngine`` takes.

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

from typing import Dict

import torch


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """Parameters of a dense or MoE decoder of ``sizes`` (see
    ``harness.sizes_of``) from ``seed``, on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    dt = getattr(torch, sizes["dtype"])
    L, D, F = sizes["n_layers"], sizes["d_model"], sizes["d_ff"]
    Q, KV = sizes["n_heads"] * sizes["head_dim"], sizes["n_kv_heads"] * sizes["head_dim"]
    V = padded_vocab(sizes["vocab_size"])
    E = sizes.get("n_experts", 0)

    def draw(shape, std, mean=0.0):
        t = torch.empty(shape, dtype=dt, device=dev)
        return t.normal_(mean, std, generator=gen)

    out_scale = L ** -0.5
    p = {"embed": draw((V, D), D ** -0.5),
         "final_norm": draw((D,), 0.1, 1.0)}
    if not sizes["tie_embeddings"]:
        p["unembed"] = draw((D, V), D ** -0.5)
    stacked = {"norm1": draw((L, D), 0.1, 1.0), "norm2": draw((L, D), 0.1, 1.0),
               "wq": draw((L, D, Q), D ** -0.5), "wk": draw((L, D, KV), D ** -0.5),
               "wv": draw((L, D, KV), D ** -0.5),
               "wo": draw((L, Q, D), Q ** -0.5 * out_scale)}
    if E:
        stacked.update(router=draw((L, D, E), D ** -0.5),
                       we_gate=draw((L, E, D, F), D ** -0.5),
                       we_up=draw((L, E, D, F), D ** -0.5),
                       we_down=draw((L, E, F, D), F ** -0.5 * out_scale))
    else:
        stacked.update(w_gate=draw((L, D, F), D ** -0.5),
                       w_up=draw((L, D, F), D ** -0.5),
                       w_down=draw((L, F, D), F ** -0.5 * out_scale))
    ffn_keys = (("router", "we_gate", "we_up", "we_down") if E
                else ("w_gate", "w_up", "w_down"))
    p["layers"] = [
        {"norm1": stacked["norm1"][l], "norm2": stacked["norm2"][l],
         "attn": {k: stacked[k][l] for k in ("wq", "wk", "wv", "wo")},
         ("moe" if E else "mlp"): {k: stacked[k][l] for k in ffn_keys}}
        for l in range(L)]
    return p

