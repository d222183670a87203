"""The master weights of a configuration, made on the device from the
run's seed in one draw: one ``normal_`` over a flat f32 buffer (the
masters' type), whose slices become the leaves, each scaled in place.
The tree has the program's layout (stacked ``[L, ...]`` leaves); the same
tensors go to the program and to the plain reference."""
from __future__ import annotations

import math

import torch

__all__ = ["leaf_specs", "make_params", "n_params"]


def leaf_specs(m: dict) -> list[tuple[tuple, tuple, str, float]]:
    """``(path, shape, init, scale)`` of every leaf: ``init`` is
    ``normal`` (times ``scale``), ``ones`` or ``small`` (normal times
    0.02). Linears are ``N(0, 1/d_in)``, the embedding, an untied head
    and a router ``N(0, 0.02^2)``, norm gains one."""
    L, d, hd = m["n_layers"], m["d_model"], m.get("head_dim") or (
        m["d_model"] // m["n_heads"])
    H, Hkv = m["n_heads"], m["n_kv"]
    qkv_out = (H + 2 * Hkv) * hd
    out = [(("layers", "qkv", "w"), (L, d, qkv_out), "normal", d ** -0.5),
           (("layers", "attn_out", "w"), (L, H * hd, d), "normal",
            (H * hd) ** -0.5),
           (("layers", "norm_attn", "g"), (L, d), "ones", 1.0),
           (("layers", "norm_mlp", "g"), (L, d), "ones", 1.0)]
    if m.get("qkv_bias"):
        out.append((("layers", "qkv", "b"), (L, qkv_out), "small", 0.02))
    moe = m.get("moe")
    if moe is None:
        f = m["d_ff"]
        out += [(("layers", "mlp", "w_in", "w"), (L, d, 2 * f), "normal",
                 d ** -0.5),
                (("layers", "mlp", "w_out", "w"), (L, f, d), "normal",
                 f ** -0.5)]
    else:
        E, f = moe["n_routed"], moe["d_expert"]
        fs = f * moe["n_shared"]
        out += [(("layers", "moe", "router", "w"), (L, d, E), "small", 0.02),
                (("layers", "moe", "w_in"), (L, E, d, 2 * f), "normal",
                 d ** -0.5),
                (("layers", "moe", "w_out"), (L, E, f, d), "normal",
                 f ** -0.5)]
        if fs:
            out += [(("layers", "moe", "shared_in", "w"), (L, d, 2 * fs),
                     "normal", d ** -0.5),
                    (("layers", "moe", "shared_out", "w"), (L, fs, d),
                     "normal", fs ** -0.5)]
    out += [(("norm_f", "g"), (d,), "ones", 1.0),
            (("embed", "w"), (m["vocab"], d), "small", 0.02)]
    if not m.get("tie_embeddings"):
        out.append((("lm_head", "w"), (d, m["vocab"]), "small", 0.02))
    return out


def n_params(m: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in leaf_specs(m))


def make_params(m: dict, seed: int, device) -> dict:
    """The weight tree of model fields ``m`` from ``seed`` on ``device``."""
    specs = leaf_specs(m)
    total = sum(math.prod(s) for _, s, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    tree: dict = {}
    at = 0
    for path, shape, init, scale in specs:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        if init == "ones":
            leaf.fill_(1.0)
        else:
            leaf.mul_(scale)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
