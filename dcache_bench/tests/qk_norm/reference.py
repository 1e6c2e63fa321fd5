"""Plain float32 reference of a served request on a dense decoder whose
attention RMS-normalises q and k over each head, with the gains
``q_norm`` and ``k_norm``, before the rotary embedding; added to a tree as
``reference/qk_norm_decoder.py``. It imports nothing of the program and
takes the tokenizer, norm, rotary embedding and attention of
``reference/decoder.py``, loaded from its file beside this one.

A dense model has no pads that reach a true token, so the prompt and the
served tokens but the last go through the layers as one causal sequence.
"""
import importlib.util
from pathlib import Path

import torch

_spec = importlib.util.spec_from_file_location(
    "dcache_bench_reference_decoder_base", Path(__file__).with_name("decoder.py"))
base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(base)

tokenize = base.tokenize
plain_linear = base.plain_linear


@torch.no_grad()
def served_logits(sizes, params, prompt_ids, served, *, max_len,
                  linear=plain_linear):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = params["embed"].device
    eps, theta, hd = sizes["norm_eps"], sizes["rope_theta"], sizes["head_dim"]
    ids = torch.tensor(list(prompt_ids) + list(served[:-1]), device=dev)
    pos = torch.arange(ids.numel(), device=dev)
    S = ids.numel()
    x = params["embed"][ids].float()
    for lp in params["layers"]:
        a = lp["attn"]
        h = base._rms(x, lp["norm1"], eps)
        q = base._rms(linear(h, a["wq"]).view(S, -1, hd), a["q_norm"], eps)
        k = base._rms(linear(h, a["wk"]).view(S, -1, hd), a["k_norm"], eps)
        q, k = base._rope(q, pos, theta), base._rope(k, pos, theta)
        v = linear(h, a["wv"]).view(S, -1, hd)
        o = base._attend(q, k, v, pos, pos, sizes.get("sliding_window"))
        x = x + linear(o.reshape(S, -1), a["wo"])
        m = lp["mlp"]
        h = base._rms(x, lp["norm2"], eps)
        x = x + linear(torch.nn.functional.silu(linear(h, m["w_gate"]))
                       * linear(h, m["w_up"]), m["w_down"])
    h = base._rms(x[len(prompt_ids) - 1:], params["final_norm"], eps)
    w = params["embed"].t() if sizes["tie_embeddings"] else params["unembed"]
    return linear(h, w)[:, :sizes["vocab_size"]]
