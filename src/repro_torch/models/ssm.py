"""Mamba2 — the State-Space Duality (SSD) block (port of
``repro/models/ssm.py``): chunked prefill in matmul form and the O(1)-state
recurrent decode step.

The reference computes the whole block outside any Pallas kernel, so it is
plain PyTorch here too: the intra-chunk ``[Q, Q]`` products and the chunk
states are ``torch.einsum``, and the reference's ``lax.scan`` over chunk
states is a loop over the ``S / Q`` chunks in f32. The projections run
through :func:`~repro_torch.models.layers.qlinear` (sites ``ssm_in`` /
``ssm_out``), so native weights reach K3 and weight images K5 as on the
dense path.

Parameters are stacked ``[L, ...]`` like the transformer's; the functions
below take one layer's view. Dtypes follow the reference per path: at
prefill the causal conv multiplies the projection (the compute dtype) by
the f32 conv weights, which promotes to f32; at decode the conv window is
f32 throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .layers import init_linear, qlinear, rms_norm
from .pshard import constrain

__all__ = ["SSMConfig", "SSMState", "init_ssm", "init_ssm_state",
           "ssd_forward", "ssm_decode_step", "softplus"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """The reference's SSD hyper-parameters, field for field."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


def init_ssm(gen: torch.Generator, d_model: int, cfg: SSMConfig, *,
             layers: int, device=None) -> dict:
    """``layers`` stacked blocks with the reference's distributions:
    ``in_proj`` → ``[z, xBC, dt]`` and ``out_proj`` as linears, conv
    weights ``N(0, 1/d_conv)``, ``A = linspace(1, 16)`` per head,
    ``D = 1``, ``dt_bias = softplus⁻¹(0.01)``, the gate norm at one."""
    di, h = cfg.d_inner(d_model), cfg.n_heads(d_model)
    cd = cfg.conv_dim(d_model)
    n_in = 2 * di + 2 * cfg.n_groups * cfg.d_state + h

    def per_layer(v: torch.Tensor) -> torch.Tensor:
        return v.to(device).unsqueeze(0).expand(layers, *v.shape).clone()

    return {
        "in_proj": init_linear(gen, d_model, n_in, layers=layers,
                               device=device),
        "out_proj": init_linear(gen, di, d_model, layers=layers,
                                device=device),
        "conv_w": torch.randn(layers, cfg.d_conv, cd, generator=gen,
                              device=device, dtype=torch.float32)
        / np.sqrt(cfg.d_conv),
        "conv_b": torch.zeros(layers, cd, device=device),
        "A_log": per_layer(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": per_layer(torch.ones(h)),
        "dt_bias": per_layer(torch.log(torch.expm1(torch.full((h,), 1e-2)))),
        "norm_g": per_layer(torch.ones(di)),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(−|x|))``; ``F.softplus`` switches to ``x`` above 20."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(proj: torch.Tensor, d_model: int, cfg: SSMConfig):
    """``in_proj``'s output → ``(z, xBC, dt)``; ``xBC`` is pre-conv."""
    di = cfg.d_inner(d_model)
    gn = cfg.n_groups * cfg.d_state
    return torch.split(proj, [di, di + 2 * gn, cfg.n_heads(d_model)], dim=-1)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums ``out[..., i, j] = Σ_{j<k<=i} a[...,
    k]``, as the plain difference of cumsums (the reference's formula),
    ``-inf`` above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, torch.full((), float("-inf"),
                                             device=a.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, ``xbc [B, S, C]``, ``w [K, C]``,
    summed tap by tap in the reference's order, then SiLU."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _heads(t: torch.Tensor, g: int, n: int, rep: int) -> torch.Tensor:
    """``[..., g·n]`` → ``[..., g·rep, n]`` f32: groups broadcast to heads
    (``jnp.repeat`` order)."""
    t = t.reshape(*t.shape[:-1], g, n).float()
    return torch.repeat_interleave(t, rep, dim=-2)


def ssd_forward(params: dict, x: torch.Tensor, bits_in, bits_out,
                cfg: SSMConfig, return_final_state: bool = False,
                valid: Optional[torch.Tensor] = None):
    """Chunked SSD over a full sequence, ``x [B, S, d_model]`` → the same
    shape; with ``return_final_state`` also ``(h [B, H, P, N] f32,
    conv_tail [B, K−1, convdim])``, the prefill → decode handoff.

    ``valid [B, S]`` marks the real tokens of a left-padded ragged batch:
    pad inputs are zeroed before ``in_proj`` (the conv sees the same zero
    left context as a solo run and the handed-off tail's pads are zero) and
    pad steps' ``dt`` is zeroed (decay 1, no input: the state passes
    through). Padding to a whole number of chunks zeroes ``dt`` the same
    way. A prompt shorter than ``K − 1`` left-pads its tail."""
    bsz, s_real, d_model = x.shape
    if valid is not None:
        x = torch.where(valid[..., None], x,
                        torch.zeros((), dtype=x.dtype, device=x.device))
    di = cfg.d_inner(d_model)
    h_heads, p_dim = cfg.n_heads(d_model), cfg.head_dim
    n, g = cfg.d_state, cfg.n_groups
    q = min(cfg.chunk, s_real)
    pad = (-s_real) % q
    s = s_real + pad
    nc = s // q

    proj = qlinear(params["in_proj"], x, bits_in)
    z, xbc, dt = _split_proj(proj, d_model, cfg)
    conv_tail = xbc[:, max(0, s_real - (cfg.d_conv - 1)):s_real, :]
    if s_real < cfg.d_conv - 1:
        conv_tail = F.pad(conv_tail, (0, 0, cfg.d_conv - 1 - s_real, 0))
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    xs, b_, c_ = torch.split(xbc, [di, g * n, g * n], dim=-1)

    xh = xs.reshape(bsz, s, h_heads, p_dim).float()
    # SSD head counts (24/50) rarely divide the TP axis: shard the head
    # dim P instead
    xh = constrain(xh, "dp", None, None, "tp")
    rep = h_heads // g
    bh = _heads(b_, g, n, rep)                           # [B, S, H, N]
    ch = _heads(c_, g, n, rep)

    a = -torch.exp(params["A_log"].float())              # [H], negative
    dt = softplus(dt.float() + params["dt_bias"])        # [B, S, H]
    if valid is not None:
        vmask = valid.float()
        if pad:
            vmask = F.pad(vmask, (0, pad))
        dt = dt * vmask[:, :, None]
    elif pad:
        cmask = (torch.arange(s, device=x.device) < s_real).float()
        dt = dt * cmask[None, :, None]
    da = dt * a                                          # [B, S, H]
    xdt = xh * dt[..., None]

    def chunked(t):                                      # [B, S, ...] → [B, nc, Q, ...]
        return t.reshape(bsz, nc, q, *t.shape[2:])

    xc, bc, cc = chunked(xdt), chunked(bh), chunked(ch)
    dac = chunked(da).permute(0, 3, 1, 2)                # [B, H, nc, Q]

    # intra-chunk (diagonal blocks): (C·Bᵀ ∘ L) · x
    l_mat = torch.exp(_segsum(dac))                      # [B, H, nc, Q, Q]
    l_mat = constrain(l_mat, "dp", None, None, "tp", None)
    cb = torch.einsum("bclhn,bcshn->bhcls", cc, bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb * l_mat, xc)
    y_diag = constrain(y_diag, "dp", None, "tp", None, None)

    # chunk states and the inter-chunk recurrence
    dac_cum = torch.cumsum(dac, dim=-1)                  # [B, H, nc, Q]
    decay_states = torch.exp(dac_cum[..., -1:] - dac_cum)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bclhp,bclhn->bchpn", xd, bc)  # [B, nc, H, P, N]
    chunk_decay = torch.exp(dac_cum[..., -1])            # [B, H, nc]
    h_state = torch.zeros((bsz, h_heads, p_dim, n), dtype=torch.float32,
                          device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_state)
        h_state = h_state * chunk_decay[:, :, c, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                 # [B, nc, H, P, N]

    # inter-chunk contribution
    state_decay = torch.exp(dac_cum).permute(0, 2, 3, 1)[..., None]
    y_off = torch.einsum("bclhn,bchpn->bclhp", cc, h_prev) * state_decay
    y_off = constrain(y_off, "dp", None, "tp", None, None)

    y = (y_diag + y_off).reshape(bsz, s, h_heads, p_dim)
    y = y + xh * params["D"][None, None, :, None]        # skip
    y = y.reshape(bsz, s, di)[:, :s_real]                # trim chunk padding
    y = y * F.silu(z.float())                            # gate
    y = rms_norm({"g": params["norm_g"]}, y)
    out = qlinear(params["out_proj"], y.to(x.dtype), bits_out)
    if return_final_state:
        return out, (h_state, conv_tail)
    return out


@dataclasses.dataclass
class SSMState:
    """Decode-time recurrent state, one layer or stacked ``[L, ...]``:
    ``h [B, H, P, N]`` f32, the SSD state, and ``conv [B, K−1, convdim]``
    f32, the causal conv's window of past inputs."""

    h: torch.Tensor
    conv: torch.Tensor

    def layer(self, l: int) -> "SSMState":
        """Per-layer view of a stacked state (writes land in the stack)."""
        return SSMState(self.h[l], self.conv[l])


def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig,
                   device=None) -> SSMState:
    return SSMState(
        h=torch.zeros((batch, cfg.n_heads(d_model), cfg.head_dim,
                       cfg.d_state), device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim(d_model)),
                         device=device))


def ssm_decode_step(params: dict, x: torch.Tensor, state: SSMState,
                    bits_in, bits_out, cfg: SSMConfig) -> torch.Tensor:
    """One-token recurrent step, ``x [B, 1, d_model]`` → ``y [B, 1,
    d_model]``; ``state`` is updated in place."""
    bsz, _, d_model = x.shape
    di = cfg.d_inner(d_model)
    h_heads, p_dim = cfg.n_heads(d_model), cfg.head_dim
    n, g = cfg.d_state, cfg.n_groups

    proj = qlinear(params["in_proj"], x, bits_in)[:, 0]  # [B, ...]
    z, xbc, dt = _split_proj(proj, d_model, cfg)

    window = torch.cat([state.conv, xbc[:, None, :].float()], dim=1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, params["conv_w"])
                      + params["conv_b"])

    xs, b_, c_ = torch.split(conv_out, [di, g * n, g * n], dim=-1)
    xh = xs.reshape(bsz, h_heads, p_dim).float()
    rep = h_heads // g
    bh, ch = _heads(b_, g, n, rep), _heads(c_, g, n, rep)  # [B, H, N]

    a = -torch.exp(params["A_log"].float())
    dt = softplus(dt.float() + params["dt_bias"])        # [B, H]
    dec = torch.exp(dt * a)
    h_new = state.h * dec[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh * dt[..., None], bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, ch) + xh * params["D"][None, :, None]
    y = y.reshape(bsz, di) * F.silu(z.float())
    y = rms_norm({"g": params["norm_g"]}, y)
    state.h.copy_(h_new)
    state.conv.copy_(window[:, 1:])
    return qlinear(params["out_proj"], y[:, None, :].to(x.dtype), bits_out)
