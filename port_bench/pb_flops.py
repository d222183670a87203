"""The yardstick: the card's published peaks, and the operations and bytes
the served work needs, reckoned from the configuration's shapes and the
requests the harness sent. Nothing here reads the program."""
from __future__ import annotations

import math

__all__ = ["PEAK", "matmul_params", "token_flops", "prefill_flops",
           "kv_bytes_per_token", "k1_step_bytes", "k5_forward_bytes"]

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK = {"bf16_flops": 989e12, "fp8_flops": 1979e12, "f32_flops": 67e12,
        "hbm_bytes_s": 3.35e12, "hbm_bytes": 80e9}


def _hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def matmul_params(m: dict) -> tuple[int, int]:
    """``(per layer, head)``: the weights one token multiplies through, the
    MoE's routed experts at ``top_k`` of them and every shared one."""
    d, H, Hkv, hd = m["d_model"], m["n_heads"], m["n_kv"], _hd(m)
    attn = d * (H + 2 * Hkv) * hd + H * hd * d
    moe = m.get("moe")
    if moe is None:
        ffn = 3 * d * m["d_ff"]
    else:
        f = moe["d_expert"]
        ffn = (d * moe["n_routed"] + moe["top_k"] * 3 * d * f
               + moe["n_shared"] * 3 * d * f)
    return attn + ffn, d * m["vocab"]


def token_flops(m: dict, ctx: int, head: bool = True) -> float:
    """One token's forward at a context of ``ctx`` keys (itself included):
    2 per multiply-add of the matmuls, and 4·ctx·H·hd per layer for the
    scores and the weighted sum; the head only where the token yields an
    output."""
    layer, hd_params = matmul_params(m)
    att = 4 * ctx * m["n_heads"] * _hd(m)
    return m["n_layers"] * (2 * layer + att) + (2 * hd_params if head else 0)


def prefill_flops(m: dict, plen: int) -> float:
    """A prompt's prefill: every position at its causal context, the head
    at the last one."""
    layer, hd_params = matmul_params(m)
    att = 4 * m["n_heads"] * _hd(m) * plen * (plen + 1) // 2
    return (m["n_layers"] * (2 * layer * plen + att) + 2 * hd_params)


def kv_bytes_per_token(m: dict, kv_bits: int) -> float:
    """K and V of one token over all layers."""
    return m["n_layers"] * 2 * m["n_kv"] * _hd(m) * kv_bits / 8


def k1_step_bytes(m: dict, kv_bits: int, ctx: int) -> float:
    """What one live row's decode attention needs over all layers: its
    ``ctx`` keys' K and V once, the query and the output once in bf16."""
    q_out = 2 * m["n_heads"] * _hd(m) * 2
    return kv_bytes_per_token(m, kv_bits) * ctx + m["n_layers"] * q_out


def k5_forward_bytes(m: dict, tokens: int) -> float:
    """What the MoE's per-forward fake-quants need, over all layers: each
    routed stack read once in f32 and written once in bf16, and the two
    dispatch buffers (``[G, E, cap, d]`` and ``[G, E, cap, f]`` in bf16)
    read and written once, for a forward over ``tokens`` token slots
    (padding included: the buffers are sized by it)."""
    moe = m["moe"]
    E, f, d, k = moe["n_routed"], moe["d_expert"], m["d_model"], moe["top_k"]
    G = math.gcd(moe["groups"], tokens)   # a decode step's gcd(groups, B)
    tg = tokens // G
    cap = math.ceil(tg * k / E * moe["capacity_factor"])
    stacks = E * (d * 2 * f + f * d) * (4 + 2)
    bufs = G * E * cap * (d + f) * (2 + 2)
    return m["n_layers"] * (stacks + bufs)
