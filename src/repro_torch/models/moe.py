"""Fine-grained Mixture-of-Experts (port of ``repro/models/moe.py``):
shared experts (always-on gated FFNs) plus routed experts with top-k gating
and grouped capacity dispatch.

Tokens are reshaped into ``G`` groups of ``tg`` so routing, the per-expert
rank cumsum and the scatter stay group-local; each (group, expert) holds
``cap = ceil(tg·k/E · capacity_factor)`` slots of an ``[G, E, cap, d]``
buffer, so the expert compute is ``E·cap``-bounded. Assignments past an
expert's capacity, and every assignment of an invalid token (a pad row, a
left-pad slot, a retired decode row: ``token_valid``), go to one overflow
row that is dropped, so capacity is allocated from the live tokens only.

The routed experts' weights are stacked ``[E, d, 2f]`` / ``[E, f, d]`` and
fake-quantized per tensor on every forward (:func:`fake_quant_dynamic`, K5
on the card), as are the two dispatch buffers; a native stack (a
:class:`~repro_torch.core.quantizers.QTensor`) is dequantized instead
(:func:`routed_dequant`). The two batched products run outside any
kernel, as the reference computes them outside Pallas. All other products
go through :func:`~repro_torch.models.layers.qlinear` at the ``router``,
``shared_in`` and ``shared_out`` sites.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.quantizers import QTensor, dequantize, fake_quant_dynamic
from repro_torch.runtime import compute_dtype
from .layers import SIGNED_SYM, init_linear, qlinear
from .pshard import constrain

__all__ = ["MoEConfig", "MOE_SITES", "init_moe", "moe_ffn", "routed_dequant",
           "top_k_stable"]

MOE_SITES = ("router", "expert_in", "expert_out", "shared_in", "shared_out")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's fields and defaults, one for one."""

    n_routed: int
    top_k: int
    n_shared: int
    d_expert: int              # per-expert FFN width (fine-grained)
    capacity_factor: float = 1.25
    groups: int = 16           # dispatch groups
    aux_coef: float = 0.01
    z_coef: float = 1e-3


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
             layers: Optional[int] = None, device=None) -> dict:
    """The reference's distributions, drawn in its order (router, routed
    ``w_in``, routed ``w_out``, shared ``shared_in``/``shared_out``);
    ``layers`` stacks ``L`` draws on axis 0. The routed stacks are scaled
    in place: qwen2-moe's ``w_in`` alone is 33.2 GB of f32."""
    E, f = cfg.n_routed, cfg.d_expert
    lead = () if layers is None else (layers,)

    def randn(*shape):
        return torch.randn(*lead, *shape, generator=gen, device=device,
                           dtype=torch.float32)

    p = {"router": init_linear(gen, d_model, E, scale=0.02, layers=layers,
                               device=device),
         "w_in": randn(E, d_model, 2 * f).mul_(1.0 / np.sqrt(d_model)),
         "w_out": randn(E, f, d_model).div_(np.sqrt(f))}
    if cfg.n_shared:
        fs = f * cfg.n_shared
        p["shared_in"] = init_linear(gen, d_model, 2 * fs, layers=layers,
                                     device=device)
        p["shared_out"] = init_linear(gen, fs, d_model, layers=layers,
                                      device=device)
    return p


def routed_dequant(qt: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """A native routed stack dequantized whole to ``dtype`` (the
    reference's ``_qmat`` on a ``QTensor``); counted in
    ``routed_dequant.calls``."""
    routed_dequant.calls += 1
    return dequantize(qt, dtype)


routed_dequant.calls = 0


def _qmat(w, bits_aw, dtype: torch.dtype) -> torch.Tensor:
    """A routed stack as the batched product reads it: the native carrier
    dequantized, or the float master fake-quantized per tensor at the
    site's weight bits."""
    if isinstance(w, QTensor):
        return routed_dequant(w, dtype)
    return fake_quant_dynamic(w, int(bits_aw[1]), SIGNED_SYM, out_dtype=dtype)


def top_k_stable(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values (a stable
    descending sort; ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(params: dict, x: torch.Tensor, bits: dict, cfg: MoEConfig,
            token_valid: Optional[torch.Tensor] = None):
    """``x [B, S, d]`` → ``(y [B, S, d], aux)``, ``aux`` the reference's
    ``{"load_balance", "router_z"}`` (0-d f32 tensors).

    ``bits`` maps each of :data:`MOE_SITES` to its ``(a_bits, w_bits)``.
    ``token_valid [B, S]`` (bool, optional) drops invalid tokens from the
    dispatch: they advance no expert's rank and take no slot, so they never
    displace a live token. ``B·S`` must be a multiple of ``cfg.groups``.

    At bf16 compute each batched product returns in bf16, rounded once
    from its f32 accumulator (the port's :func:`~repro_torch.models.
    layers.qlinear` convention), where the reference keeps the f32
    accumulator; at f32 compute the two agree.
    """
    b, s, d = x.shape
    E, k, G = cfg.n_routed, cfg.top_k, cfg.groups
    t = b * s
    if t % G:
        raise ValueError(f"tokens {t} must divide groups {G}")
    tg = t // G
    cap = int(math.ceil(tg * k / E * cfg.capacity_factor))
    dev = x.device

    xg = x.reshape(G, tg, d)

    # ---- router (quantized like any other site) ----
    logits = qlinear(params["router"], xg, bits["router"]).float()
    probs = torch.softmax(logits, dim=-1)                    # [G, tg, E]
    gate_vals, gate_idx = top_k_stable(probs, k)             # [G, tg, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # GShard aux: mean prob per expert × fraction of tokens routed to it
    me = probs.mean(dim=(0, 1))                              # [E]
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, gate_idx.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), dtype=torch.float32, device=dev))
    aux = {"load_balance": E * torch.sum(me * ce) * cfg.aux_coef,
           "router_z": cfg.z_coef * torch.mean(
               torch.logsumexp(logits, dim=-1) ** 2)}

    # ---- group-local capacity dispatch, token-major and k-minor ----
    flat_e = gate_idx.reshape(G, tg * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)            # [G, tg·k, E]
    flat_tv = None
    if token_valid is not None:
        flat_tv = token_valid.reshape(G, tg).repeat_interleave(k, dim=1)
        onehot = onehot * flat_tv[..., None].to(torch.int32)
    pos = torch.cumsum(onehot, dim=1) - 1                    # rank in expert
    pos_in_e = torch.sum(pos * onehot, dim=-1)               # [G, tg·k]
    keep = pos_in_e < cap
    if flat_tv is not None:
        keep = keep & flat_tv
    buf_idx = torch.where(keep, flat_e * cap + pos_in_e,
                          torch.full((), E * cap, dtype=flat_e.dtype,
                                     device=dev))            # overflow row
    x_rep = xg.repeat_interleave(k, dim=1)                   # [G, tg·k, d]
    buf = torch.zeros((G, E * cap + 1, d), dtype=x.dtype, device=dev)
    # duplicate indices land only on the overflow row, which is dropped
    buf.scatter_(1, buf_idx[..., None].expand(-1, -1, d), x_rep)
    buf = buf[:, :-1].reshape(G, E, cap, d)
    # groups on dp, experts on tp (EP); capacity-sharded where E does not
    # divide the model axis
    buf = constrain(buf, "dp", "tp", None, None)

    # ---- expert compute (batched products over the stacked experts) ----
    cdt = compute_dtype(dev)
    h = fake_quant_dynamic(buf, int(bits["expert_in"][0]), SIGNED_SYM,
                           out_dtype=cdt)
    w_in = _qmat(params["w_in"], bits["expert_in"], cdt)      # [E, d, 2f]
    h = torch.einsum("gecd,edf->gecf", h, w_in)
    g_, u_ = torch.chunk(h.float(), 2, dim=-1)
    h = (F.silu(g_) * u_).to(cdt)
    h = fake_quant_dynamic(h, int(bits["expert_out"][0]), SIGNED_SYM,
                           out_dtype=cdt)
    h = constrain(h, "dp", "tp", None, None)
    w_out = _qmat(params["w_out"], bits["expert_out"], cdt)   # [E, f, d]
    out_buf = torch.einsum("gecf,efd->gecd", h, w_out).float()
    out_buf = constrain(out_buf, "dp", "tp", None, None)

    # ---- combine: gather each assignment's row (a zero row if dropped) ----
    flat = torch.cat([out_buf.reshape(G, E * cap, d),
                      torch.zeros((G, 1, d), dtype=torch.float32,
                                  device=dev)], dim=1)
    idx = buf_idx.clamp(max=E * cap)[..., None].expand(-1, -1, d)
    y_rep = flat.gather(1, idx) * keep[..., None].to(torch.float32)
    y = (y_rep.reshape(G, tg, k, d) * gate_vals[..., None]).sum(dim=2)
    y = y.reshape(b, s, d).to(x.dtype)

    # ---- shared experts (dense path) ----
    if "shared_in" in params:
        hsh = qlinear(params["shared_in"], x, bits["shared_in"])
        gsh, ush = torch.chunk(hsh, 2, dim=-1)
        y = y + qlinear(params["shared_out"], F.silu(gsh) * ush,
                        bits["shared_out"])
    return y, aux
