"""LM assembly for the port (port of ``repro/models/transformer.py``: the
dense, the vision-language, the audio, the MoE, the SSM and the hybrid
families).

Parameters and caches keep the reference's stacked ``[L, ...]`` layout, so
conversion is one to one and the per-layer loop indexes layer ``l``. The
bits table is host data: ``bits_row`` is a numpy ``[2 + L·S, 2]`` array and
each site's ``(a_bits, w_bits)`` reaches the quantizers as Python ints.
Caches are updated in place.

Public entry points: ``init_params``, ``quant_layer_names``, ``forward``,
for training ``train_loss`` and ``chunked_xent``,
``prefill``, ``decode_step``, ``prequant_decode_weights``,
``overlay_params``, ``init_caches``, ``init_paged_caches``,
``decode_segment``, ``decode_many``, for continuation prefill
``forward_extend``, ``prefill_extend`` and ``prefix_operands``, and for
speculative decoding ``ngram_propose``, ``decode_step_spec`` and
``decode_segment_spec``, and for preemption ``paged_row_masters`` and
``amax_for_scale``.

The per-layer KV precision policy rides ``kv_sched`` (one bit-width per
layer, host ints; ``decode_segment``/``decode_many`` take the ``[P, L]``
``kv_table`` and pick the row by each step's profile): fresh K/V are
refined (:func:`~repro_torch.models.attention.kv_refine`) right after the
QKV projection in ``forward``, ``forward_extend`` and ``decode_step``, so
the attention read, the cache write, the int-KV scale and the collected
masters see the refined values. ``None`` runs exactly the policy-free ops.

The SSM family (mamba2) swaps each layer's attention and MLP for one SSD
block (:mod:`repro_torch.models.ssm`, sites ``ssm_in``/``ssm_out``) behind
an RMS norm: ``forward``/``prefill`` run the chunked scan and hand each
row's final state off as ``caches["ssm"]`` (an ``SSMState`` stacked ``[L,
...]``, no ``"kv"``), and ``decode_step`` advances that state in place.
Continuation prefill and speculation stay attention-only, as in the
reference (``supports_prefix_sharing``/``supports_speculation``).

The hybrid family (hymba) runs attention and an SSD block side by side on
one normed input per layer and merges them as ``0.5 · (rms_norm(attn) +
rms_norm(ssm))`` before the MLP; its caches hold both ``"kv"`` and
``"ssm"``. A sliding window sizes every attention row at ``eff =
min(slots, sliding_window)`` (the ring never holds a token outside the
window), and prefill past the window takes the block-skipping
:func:`~repro_torch.models.attention.swa_attention`.

The MoE family (qwen2-moe, deepseek-moe) swaps each layer's MLP for
:func:`~repro_torch.models.moe.moe_ffn` behind the same norm. Its grouped
capacity dispatch couples the tokens of a batch, so every call says which
tokens are live: ``forward``/``prefill`` pass the ragged left-pad mask, and
``decode_step`` takes ``row_valid [B]`` (``decode_segment`` passes each
step's live rows) and dispatches in ``gcd(groups, B)`` groups. ``forward``
returns the summed aux losses (load balance + router z) of the layers.

The vision-language family (qwen2-vl) is the dense layer with M-RoPE
(:func:`~repro_torch.models.rotary.apply_mrope` on text positions, as the
reference rotates) and a vision prefix: ``forward``/``prefill`` take
``patch_embeds [B, n_patches, d]`` in place of the first ``n_patches``
token embeddings (the vision tower is a stub, as in the reference);
decode steps are text. The audio family (hubert) is an encoder: layer
norms with a bias (``cfg.norm == "ln"``, through :func:`_norm` at every
site the reference normalizes), bidirectional attention, a non-gated
GELU MLP, and an ``embed`` linear over ``features [B, S, feature_dim]``;
``forward`` gives per-frame hidden states (``_logits`` the per-frame
unit logits), and the decode side (``prefill``, ``init_caches``,
``init_paged_caches``, ``decode_step``) refuses it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from .attention import (KVCache, PagedKVCache, _dequantize_kv, _mapped,
                        _quantize_kv, decode_attention,
                        decode_attention_window, gqa_attention,
                        init_kv_cache, init_paged_kv_cache, kv_refine,
                        kv_scale,
                        paged_decode_attention,
                        paged_decode_attention_window, paged_view,
                        prefix_attention, stack_layers, swa_attention,
                        update_kv_cache,
                        update_kv_cache_window, update_paged_kv_cache,
                        update_paged_kv_cache_window)
from .ssm import (SSMState, init_ssm, init_ssm_state, ssd_forward,
                  ssm_decode_step)
from .layers import (SIGNED_SYM, embed_lookup, init_embed, init_linear,
                     init_norm, layer_norm, qlinear, rms_norm)
from .mlp import init_mlp, mlp
from .moe import MOE_SITES, init_moe, moe_ffn
from .pshard import constrain
from .rotary import apply_mrope, apply_rope, text_mrope_positions
from repro_torch.core.quantizers import QTensor, dequantize, fake_quant_dynamic
from repro_torch.runtime import compute_dtype

__all__ = ["ModelConfig", "sites", "quant_layer_names", "split_bits",
           "init_params", "param_count", "active_param_count", "forward",
           "chunked_xent", "train_loss", "layer_stack",
           "prefill", "forward_extend", "prefill_extend", "prefix_operands",
           "decode_step",
           "prequant_decode_weights", "overlay_params", "eff_slots",
           "paged_block_size",
           "init_caches", "init_paged_caches", "cache_bytes",
           "supports_prefix_sharing", "supports_speculation",
           "paged_row_masters", "amax_for_scale", "decode_segment",
           "segment_buffers", "segment_step", "decode_many", "ngram_propose",
           "decode_step_spec",
           "decode_segment_spec", "segment_spec_buffers",
           "segment_spec_step"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config, field for field (the port implements all
    six of its families; ``moe`` is a
    :class:`~repro_torch.models.moe.MoEConfig`, ``ssm`` a
    :class:`~repro_torch.models.ssm.SSMConfig`)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e6
    qkv_bias: bool = False
    mrope: bool = False
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    sliding_window: int = 0
    causal: bool = True
    act: str = "silu"
    norm: str = "rms"
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    frontend: Optional[str] = None
    n_patches: int = 0
    feature_dim: int = 512
    tie_embeddings: bool = False
    remat: bool = True
    loss_chunk: int = 1024
    attn_block_k: int = 512
    scan_layers: bool = True
    unroll_inner: bool = False
    remat_policy: str = "nothing"
    swa_block_skip: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def has_attn(self) -> bool:
        return self.family in ("dense", "moe", "hybrid", "vlm", "audio")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_mlp(self) -> bool:
        return self.family in ("dense", "hybrid", "vlm", "audio")

    def window(self, skv: int) -> int:
        return self.sliding_window if self.sliding_window else skv + 1


_SITES = {"dense": ("qkv", "attn_out", "mlp_in", "mlp_out"),
          "vlm": ("qkv", "attn_out", "mlp_in", "mlp_out"),
          "audio": ("qkv", "attn_out", "mlp_in", "mlp_out"),
          "moe": ("qkv", "attn_out") + MOE_SITES,
          "ssm": ("ssm_in", "ssm_out"),
          "hybrid": ("qkv", "attn_out", "ssm_in", "ssm_out", "mlp_in",
                     "mlp_out")}
_GLOBAL_SITES = ("embed", "lm_head")


def _require_ported(cfg: ModelConfig) -> None:
    """Admit the reference's six families: dense, vlm, audio, MoE, SSM and
    hybrid (RMS or layer norm, causal or bidirectional, with or without a
    sliding window, M-RoPE or RoPE, token, vision-prefix or audio-frame
    inputs)."""
    if cfg.family not in _SITES:
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")


def _require_causal(cfg: ModelConfig, what: str) -> None:
    """Refuse the decode side of an encoder-only stack (hubert): it has
    no next token to feed, and its ``embed`` is a linear over frame
    features, not a table a token indexes."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only (causal=False): "
                         f"{what} has no decode step to serve")


def sites(cfg: ModelConfig) -> tuple[str, ...]:
    return _SITES[cfg.family]


def quant_layer_names(cfg: ModelConfig) -> tuple[str, ...]:
    """Names for Profile construction: globals + per-depth per-site."""
    return _GLOBAL_SITES + tuple(
        f"L{i}.{s}" for i in range(cfg.n_layers) for s in sites(cfg))


def split_bits(cfg: ModelConfig, bits_row):
    """bits_row [2 + L*S, 2] → (embed [2], lm_head [2], layers [L, S, 2])."""
    bits_row = np.asarray(bits_row)
    ns = len(sites(cfg))
    return (bits_row[0], bits_row[1],
            bits_row[2:].reshape(cfg.n_layers, ns, 2))


def _site_idx(cfg: ModelConfig, name: str) -> int:
    return sites(cfg).index(name)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random parameters with the reference's distributions: linears
    ``N(0, 1/d_in)``, embedding ``N(0, 0.02²)``, untied head ``N(0, 0.02²)``,
    norms at one, SSD blocks as :func:`~repro_torch.models.ssm.init_ssm`.
    Layers are drawn stacked ``[L, ...]`` from ``gen``, which must live on
    ``device``."""
    _require_ported(cfg)
    d = cfg.d_model
    p = {"layers": _init_layers(cfg, gen, device),
         "norm_f": init_norm(d, bias=cfg.norm == "ln", device=device)}
    if cfg.frontend == "audio":
        p["embed"] = init_linear(gen, cfg.feature_dim, d, device=device)
    else:
        p["embed"] = init_embed(gen, cfg.vocab, d, device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, d, cfg.vocab, scale=0.02,
                                   device=device)
    return p


def _init_layers(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """The stacked layer tree, block by block in the reference's order:
    attention, the SSD block (its norm on the pure SSM stack), the hybrid
    layer's two output norms, the MLP, the MoE block and its norm."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    ln = cfg.norm == "ln"
    p = {}
    if cfg.has_attn:
        p["qkv"] = init_linear(gen, d, (cfg.n_heads + 2 * cfg.n_kv) * hd,
                               bias=cfg.qkv_bias, layers=L, device=device)
        p["attn_out"] = init_linear(gen, cfg.n_heads * hd, d, layers=L,
                                    device=device)
        p["norm_attn"] = init_norm(d, bias=ln, layers=L, device=device)
    if cfg.has_ssm:
        p["ssm"] = init_ssm(gen, d, cfg.ssm, layers=L, device=device)
        if cfg.family == "ssm":
            p["norm_ssm"] = init_norm(d, layers=L, device=device)
    if cfg.family == "hybrid":
        p["norm_attn_out"] = init_norm(d, layers=L, device=device)
        p["norm_ssm_out"] = init_norm(d, layers=L, device=device)
    if cfg.has_mlp:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, gated=cfg.act == "silu",
                            layers=L, device=device)
        p["norm_mlp"] = init_norm(d, bias=ln, layers=L, device=device)
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, d, cfg.moe, layers=L, device=device)
        p["norm_mlp"] = init_norm(d, layers=L, device=device)
    return p


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def param_count(params) -> int:
    return sum(int(t.numel()) for t in _leaves(params))


def active_param_count(cfg: ModelConfig, params) -> int:
    """MoE-aware: routed experts count at ``top_k / E``."""
    total = param_count(params)
    if cfg.family != "moe":
        return total
    e, k = cfg.moe.n_routed, cfg.moe.top_k
    routed = cfg.n_layers * e * 3 * cfg.moe.d_expert * cfg.d_model
    return total - routed + int(routed * k / e)


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.layer(l)
    return tree[l]


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, each leaf taken apart
    once with ``torch.unbind``: the same views as :func:`_layer`, but under
    autograd one node per leaf whose backward is a single ``stack`` (a
    ``tree[l]`` per layer would write a zero-filled gradient of the whole
    stacked leaf for each layer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][l] for k in tree} for l in range(n)]
    if isinstance(tree, QTensor):
        return [QTensor(d, sc, tree.bits, tree.orig_last)
                for d, sc in zip(tree.data.unbind(0), tree.scale.unbind(0))]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(p, x) if cfg.norm == "ln" else rms_norm(p, x)


def _attn_qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor, lb,
              positions: torch.Tensor):
    """Project + rope (M-RoPE on text positions where ``cfg.mrope``, as
    the reference). Returns q [B,S,H,hd], k/v [B,S,Hkv,hd]."""
    b, s, _ = x.shape
    hd = cfg.hd
    qkv = qlinear(lp["qkv"], x, lb[_site_idx(cfg, "qkv")])
    q, k, v = torch.split(
        qkv, [cfg.n_heads * hd, cfg.n_kv * hd, cfg.n_kv * hd], dim=-1)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv, hd)
    if cfg.mrope:
        pos3 = text_mrope_positions(positions)
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv, hd)


def _kv_row(cfg: ModelConfig, kv_sched) -> Optional[list]:
    """A policy row as ``n_layers`` host ints (``None`` stays ``None``)."""
    if kv_sched is None:
        return None
    row = [int(b) for b in np.asarray(kv_sched).reshape(-1)]
    if len(row) != cfg.n_layers:
        raise ValueError(f"kv_sched has {len(row)} entries, the model "
                         f"{cfg.n_layers} layers")
    return row


def _refine(k: torch.Tensor, v: torch.Tensor, ks: Optional[list], l: int):
    """Layer ``l``'s fresh K/V under the policy row ``ks`` (or as they
    are)."""
    if ks is None:
        return k, v
    return kv_refine(k, ks[l]), kv_refine(v, ks[l])


def _attend(cfg: ModelConfig, q, k, v, s: int, kv_valid=None):
    """Prefill attention: the block-skipping sliding-window form where the
    window is shorter than the self-attention sequence, else the masked
    blockwise form (window ``cfg.window(s)``)."""
    if (cfg.sliding_window and cfg.causal and cfg.swa_block_skip
            and s > cfg.sliding_window and q.shape[1] == k.shape[1]):
        return swa_attention(q, k, v, window=cfg.sliding_window,
                             block_q=cfg.attn_block_k, kv_valid=kv_valid)
    return gqa_attention(q, k, v, causal=cfg.causal, window=cfg.window(s),
                         block_k=cfg.attn_block_k, kv_valid=kv_valid)


def _merge(lp: dict, attn: torch.Tensor, ssm_out: torch.Tensor):
    """The hybrid layer's fusion of its two branches: each normed on its
    own, then averaged."""
    return 0.5 * (rms_norm(lp["norm_attn_out"], attn)
                  + rms_norm(lp["norm_ssm_out"], ssm_out))


def _mlp_block(cfg: ModelConfig, lp: dict, lb, x: torch.Tensor):
    return mlp(lp["mlp"], _norm(cfg, lp["norm_mlp"], x),
               lb[_site_idx(cfg, "mlp_in")], lb[_site_idx(cfg, "mlp_out")],
               gated=cfg.act == "silu", act=cfg.act)


def _moe_block(cfg: ModelConfig, lp: dict, lb, x: torch.Tensor,
               token_valid, moe_cfg=None):
    """The MoE layer's FFN on the normed ``x`` → ``(y, aux dict)``."""
    bits = {name: lb[_site_idx(cfg, name)] for name in MOE_SITES}
    return moe_ffn(lp["moe"], _norm(cfg, lp["norm_mlp"], x), bits,
                   moe_cfg or cfg.moe, token_valid=token_valid)


def _embed_inputs(cfg: ModelConfig, params: dict, bits_row, batch: dict):
    """Tokens, audio frames or an image + text → hidden states, positions
    and validity.

    The audio stack runs ``batch["features"] [B, S, feature_dim]`` through
    its ``embed`` linear. The vision stack embeds ``batch["tokens"]`` and
    puts ``batch["patch_embeds"] [B, n_patches, d]`` (cast to the
    embedding's dtype, not quantized) in place of the first ``n_patches``
    columns; a batch shorter than ``n_patches`` is refused.
    ``prompt_len`` marks left-padded ragged rows: per-row positions count
    real tokens from 0 and pad embeddings are zeroed — on the vision
    stack after the patches land, so a padded row's image columns are pad
    columns and are zeroed too, as in the reference."""
    eb, _, _ = split_bits(cfg, bits_row)
    if cfg.frontend == "audio":
        feats = batch["features"]
        x = qlinear(params["embed"], feats, eb)
        dev = feats.device
    else:
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens, eb)
        dev = tokens.device
        if cfg.frontend == "vision" and cfg.n_patches:
            if tokens.shape[1] < cfg.n_patches:
                raise ValueError(
                    f"{cfg.name}: a batch of {tokens.shape[1]} columns is "
                    f"shorter than the vision prefix's {cfg.n_patches} "
                    f"patches")
            patches = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([patches, x[:, cfg.n_patches:]], dim=1)
    b, s = x.shape[:2]
    ar = torch.arange(s, dtype=torch.int32, device=dev)
    plen = batch.get("prompt_len")
    if plen is None:
        return constrain(x, "dp", None, None), ar[None].expand(b, s), None
    pad = s - _ints(plen, torch.int32, dev)
    positions = ar[None] - pad[:, None]
    valid = positions >= 0
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return constrain(x, "dp", None, None), positions, valid


def forward(params: dict, cfg: ModelConfig, bits_row, batch: dict,
            collect: bool = False, kv_sched=None):
    """Backbone over a full sequence → (hidden [B,S,d], aux, collected);
    ``collected`` is ``(k, v)``, each ``[L, B, S, Hkv, hd]``, with
    ``collect`` (the prefill → cache handoff) — on the SSM stack each
    layer's final state ``(h [L, B, H, P, N], conv_tail [L, B, K−1,
    convdim])``, on the hybrid stack ``((k, v), (h, conv_tail))``.
    ``kv_sched`` (``[L]`` bit-widths, optional) refines each layer's fresh
    K/V before attention and collection; the SSM stack has none. ``aux``
    is the MoE stack's summed aux losses (zero on the other families).

    Each stacked leaf is taken apart once (:func:`_unstack`). When
    autograd records (a parameter requires grad) and ``cfg.remat`` is
    set, each layer's body runs under :func:`_remat`: its activations are
    recomputed in the backward instead of kept."""
    _require_ported(cfg)
    x, positions, valid = _embed_inputs(cfg, params, bits_row, batch)
    _, _, layer_bits = split_bits(cfg, bits_row)
    layers = _unstack(params["layers"], cfg.n_layers)
    remat = cfg.remat and not collect and _records(params)
    if cfg.family == "ssm":
        return _forward_ssm(params, cfg, layers, layer_bits, x, valid,
                            collect, remat)
    sched = _kv_row(cfg, kv_sched)
    aux = torch.zeros((), device=x.device)
    ks, vs, hs, tails = [], [], [], []
    for l in range(cfg.n_layers):
        body = functools.partial(
            _layer_forward, cfg, layers[l], layer_bits[l], positions=positions,
            valid=valid, kv_eff=None if sched is None else sched[l],
            collect=collect)
        x, maux, col = _remat(cfg, body, x) if remat else body(x)
        if maux is not None:
            aux = aux + maux["load_balance"] + maux["router_z"]
        if collect:
            ks.append(col[0])
            vs.append(col[1])
            if cfg.family == "hybrid":
                hs.append(col[2])
                tails.append(col[3])
    x = _norm(cfg, params["norm_f"], x)
    collected = ()
    if collect:
        collected = (torch.stack(ks), torch.stack(vs))
        if cfg.family == "hybrid":
            collected = (collected, (torch.stack(hs), torch.stack(tails)))
    return x, aux, collected


def _layer_forward(cfg: ModelConfig, lp: dict, lb, x: torch.Tensor, *,
                   positions, valid, kv_eff, collect: bool):
    """One layer of an attention stack over the full sequence → ``(x,
    MoE aux dict or None, collected)``, ``collected`` being ``(k, v)`` (and
    on the hybrid stack the SSD block's ``h, conv_tail``) with
    ``collect``."""
    xin = _norm(cfg, lp["norm_attn"], x)
    q, k, v = _attn_qkv(cfg, lp, xin, lb, positions)
    if kv_eff is not None:
        k, v = kv_refine(k, kv_eff), kv_refine(v, kv_eff)
    attn = _attend(cfg, q, k, v, x.shape[1], kv_valid=valid)
    attn = qlinear(lp["attn_out"], attn.reshape(*attn.shape[:2], -1),
                   lb[_site_idx(cfg, "attn_out")])
    col = (k, v) if collect else None
    if cfg.family == "hybrid":
        out = ssd_forward(lp["ssm"], xin, *_ssm_bits(cfg, lb), cfg.ssm,
                          return_final_state=collect, valid=valid)
        if collect:
            out, (h, tail) = out
            col = (k, v, h, tail)
        x = x + _merge(lp, attn, out)
    else:
        x = constrain(x + attn, "dp", None, None)
    maux = None
    if cfg.family == "moe":
        y, maux = _moe_block(cfg, lp, lb, x, valid)
        x = x + y
    else:
        x = x + _mlp_block(cfg, lp, lb, x)
    return x, maux, col


def layer_stack(cfg: ModelConfig, layers: dict, layer_bits,
                x: torch.Tensor) -> torch.Tensor:
    """The layers of a stacked ``[n, ...]`` tree (``layer_bits [n, S,
    2]``, host ints) over hidden states ``x [B, S, d]`` at positions
    ``0 .. S−1``, no padding: the body of :func:`forward` between the
    embedding and the final norm, for a slice of the stack (a pipeline
    stage, :mod:`repro_torch.distrib.pipeline`). MoE aux losses are
    dropped (a forward-only stage)."""
    _require_ported(cfg)
    n = len(layer_bits)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    for l, lp in enumerate(_unstack(layers, n)):
        if cfg.family == "ssm":
            x, _ = _ssm_layer_forward(cfg, lp, layer_bits[l], x, valid=None,
                                      collect=False)
        else:
            x, _, _ = _layer_forward(cfg, lp, layer_bits[l], x,
                                     positions=positions, valid=None,
                                     kv_eff=None, collect=False)
    return x


def _records(tree) -> bool:
    """Whether autograd records a function of ``tree``: grad mode on and
    some leaf requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in _leaves(tree))


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy: keep the outputs of the plain matmuls
    (``aten.mm``: products with no batch dims, as the reference's
    ``dots_with_no_batch_dims_saveable``), recompute every other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under activation checkpointing, the counterpart of
    the reference's ``jax.checkpoint(..., policy=_remat_policy(cfg))``:
    ``remat_policy="nothing"`` keeps only the inputs and recomputes the
    rest in the backward; ``"dots"`` also keeps the plain matmuls'
    outputs (:func:`_save_dots`). The recompute runs the same ops on the
    same inputs, so the values and gradients are those of ``fn`` run
    plainly. No random op runs inside a layer or a loss chunk, so the
    generators' states are not stashed for the recompute (reading a CUDA
    generator's state is refused inside a CUDA graph capture)."""
    from torch.utils import checkpoint as ckpt
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def _ssm_bits(cfg: ModelConfig, lb):
    return lb[_site_idx(cfg, "ssm_in")], lb[_site_idx(cfg, "ssm_out")]


def _forward_ssm(params: dict, cfg: ModelConfig, layers: list, layer_bits,
                 x, valid, collect: bool, remat: bool):
    """:func:`forward`'s SSM stack: ``x + ssd(norm(x))`` per layer."""
    hs, tails = [], []
    for l in range(cfg.n_layers):
        body = functools.partial(_ssm_layer_forward, cfg, layers[l],
                                 layer_bits[l], valid=valid, collect=collect)
        x, col = _remat(cfg, body, x) if remat else body(x)
        if collect:
            hs.append(col[0])
            tails.append(col[1])
    x = _norm(cfg, params["norm_f"], x)
    aux = torch.zeros((), device=x.device)
    return x, aux, (torch.stack(hs), torch.stack(tails)) if collect else ()


def _ssm_layer_forward(cfg: ModelConfig, lp: dict, lb, x: torch.Tensor, *,
                       valid, collect: bool):
    """One layer of the SSM stack → ``(x, (h, conv_tail) or None)``."""
    out = ssd_forward(lp["ssm"], _norm(cfg, lp["norm_ssm"], x),
                      *_ssm_bits(cfg, lb), cfg.ssm,
                      return_final_state=collect, valid=valid)
    col = None
    if collect:
        out, col = out
    return x + out, col


def _lm_head_params(cfg: ModelConfig, params: dict) -> dict:
    head = params.get("lm_head")
    if head is not None and "wfq" in head:
        return head                      # prequant image (tied: see below)
    if cfg.tie_embeddings:
        emb = params["embed"]
        if "wq" in emb:                  # native: dequantize the tied table
            return {"w": dequantize(emb["wq"], torch.float32).t()}
        return {"w": emb["w"].t()}
    return head


def _logits(cfg: ModelConfig, params: dict, bits_row, h: torch.Tensor):
    _, hb, _ = split_bits(cfg, bits_row)
    return qlinear(_lm_head_params(cfg, params), h, hb).float()


class _PickGold(torch.autograd.Function):
    """``logits[..., idx]`` (the gold logit of each position); its
    backward places ``g`` at ``idx`` by a comparison, not by a scatter
    (the ``gather`` backward, ``scatter_add``, accumulates with atomics on
    CUDA), so it is deterministic on every device."""

    @staticmethod
    def forward(ctx, logits, idx):
        ctx.save_for_backward(idx)
        ctx.vocab = logits.shape[-1]
        return torch.gather(logits, -1, idx[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        hit = torch.arange(ctx.vocab, device=g.device) == idx[..., None]
        return torch.where(hit, g[..., None], 0.0).to(g.dtype), None


def _chunk_loss(cfg: ModelConfig, params: dict, bits_row, h: torch.Tensor,
                labels: torch.Tensor):
    """One chunk's ``(sum of masked nll, count)``: ``logsumexp − gold``
    over the positions whose label is ``>= 0``."""
    logits = constrain(_logits(cfg, params, bits_row, h), "dp", None, "tp")
    logz = torch.logsumexp(logits, dim=-1)
    gold = _PickGold.apply(logits, labels.clamp_min(0).long())
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def chunked_xent(cfg: ModelConfig, params: dict, bits_row,
                 hidden: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with sequence-chunked logits: the head runs one
    ``cfg.loss_chunk`` slice of the sequence at a time, so the ``[B, S, V]``
    logits never exist. A label ``< 0`` (``-100``) is masked out; the
    result is the total over the count, the count floored at 1. Under
    autograd with ``cfg.remat`` each chunk is recomputed in the backward
    (:func:`_remat`), as the reference checkpoints ``chunk_loss``. A
    sequence that the chunk does not divide is refused (the reference
    asserts)."""
    b, s, _ = hidden.shape
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"{cfg.name}: loss_chunk {c} does not divide the "
                         f"sequence of {s}")
    remat = cfg.remat and (hidden.requires_grad or _records(params))
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(s // c):
        part = functools.partial(_chunk_loss, cfg, params, bits_row)
        args = (hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c])
        nll, m = _remat(cfg, part, *args) if remat else part(*args)
        tot = tot + nll
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(params: dict, cfg: ModelConfig, bits_row, batch: dict):
    """Next-token (or, on the encoder, frame-classification) loss plus the
    MoE aux loss → ``(loss, {"xent", "aux"})``. ``batch["labels"]`` are
    already shifted by the data pipeline (frame targets on the audio
    stack)."""
    hidden, aux, _ = forward(params, cfg, bits_row, batch)
    labels = torch.as_tensor(batch["labels"], device=hidden.device)
    loss = chunked_xent(cfg, params, bits_row, hidden, labels)
    return loss + aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kv_dtype(kv_bits: int) -> torch.dtype:
    return torch.float32 if kv_bits == 32 else torch.bfloat16


def eff_slots(cfg: ModelConfig, slots: int) -> int:
    """Slots of one attention row: a sliding-window stack holds only its
    window."""
    return min(slots, cfg.sliding_window) if cfg.sliding_window else slots


def init_caches(cfg: ModelConfig, batch: int, slots: int, *,
                kv_bits: int = 16, device=None) -> dict:
    """Contiguous decode caches, stacked ``[L, ...]``: ``"kv"`` (``[B,
    min(slots, sliding_window)]`` rows) on an attention stack, ``"ssm"``
    (O(1) per row) on a stack with SSD blocks."""
    _require_causal(cfg, "init_caches")
    caches = {}
    if cfg.has_attn:
        one = init_kv_cache(batch, eff_slots(cfg, slots), cfg.n_kv, cfg.hd,
                            bits=kv_bits, dtype=_kv_dtype(kv_bits),
                            device=device)
        caches["kv"] = stack_layers(one, cfg.n_layers)
    return _with_ssm_state(cfg, batch, caches, device)


def _with_ssm_state(cfg: ModelConfig, batch: int, caches: dict,
                    device) -> dict:
    if cfg.has_ssm:
        caches["ssm"] = stack_layers(
            init_ssm_state(batch, cfg.d_model, cfg.ssm, device=device),
            cfg.n_layers)
    return caches


def paged_block_size(cfg: ModelConfig, slots: int, block_size: int) -> int:
    """Largest block size ≤ ``block_size`` compatible with ``cfg`` (a
    divisor of the sliding window where there is one)."""
    bs = max(1, int(block_size))
    if cfg.sliding_window:
        eff = eff_slots(cfg, slots)
        while eff % bs and bs > 1:
            bs -= 1
    return bs


def init_paged_caches(cfg: ModelConfig, batch: int, slots: int, *,
                      kv_bits: int = 16, block_size: int = 16,
                      pool_blocks: Optional[int] = None,
                      device=None) -> dict:
    """Paged decode caches: ``pool_blocks`` physical blocks of
    ``block_size`` tokens shared by ``batch`` rows, each with a
    ``[ceil(eff / block_size)]`` block table (``eff = min(slots,
    sliding_window)``); ``None`` provisions the contiguous footprint. SSM
    state stays dense, as in :func:`init_caches`."""
    _require_causal(cfg, "init_paged_caches")
    caches = {}
    if cfg.has_attn:
        bs = paged_block_size(cfg, slots, block_size)
        n_lblk = -(-eff_slots(cfg, slots) // bs)
        nb = batch * n_lblk if pool_blocks is None else int(pool_blocks)
        one = init_paged_kv_cache(batch, nb, bs, n_lblk, cfg.n_kv, cfg.hd,
                                  bits=kv_bits, dtype=_kv_dtype(kv_bits),
                                  device=device)
        caches["kv"] = stack_layers(one, cfg.n_layers)
    return _with_ssm_state(cfg, batch, caches, device)


def cache_bytes(caches) -> int:
    """Device bytes held by a cache tree (pools, tables, scales, SSM
    state)."""
    total = 0
    for c in caches.values():
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
    return total


def supports_prefix_sharing(cfg: ModelConfig) -> bool:
    """Whether a stack's KV is per-position state only, so a prefix's
    blocks can be mapped by any row: full causal attention, no SSM
    recurrence, no MoE capacity dispatch (which couples tokens across the
    batch), no sliding-window ring."""
    return (cfg.has_attn and not cfg.has_ssm and cfg.family != "moe"
            and not cfg.sliding_window and cfg.causal)


def supports_speculation(cfg: ModelConfig, kv_bits: int = 16) -> bool:
    """Whether draft/verify speculative decoding is exact for this stack:
    the prefix-sharing requirements (a rejected draft must be rollable
    back, and a ring could wrap a speculative tail onto live slots) plus
    kv16/kv8 — the packed int4 cache has no per-query dequant ladder."""
    return supports_prefix_sharing(cfg) and kv_bits in (8, 16)


def paged_row_masters(kv_pool: PagedKVCache, slot: int, block_ids,
                      n_tok: int):
    """f32 K/V masters of one paged row's first ``n_tok`` tokens, the
    preemption snapshot: the row's mapped blocks (``block_ids`` in logical
    order, shared copy-on-write blocks included) gathered into ``(mk, mv)``
    ``[L, n_tok, Hkv, hd]``. An int pool is dequantized under the row's
    *current* scales: not what early tokens were written as (the running
    scale has moved since), but exactly the values whose re-quantization
    under that scale gives back the stored ints, which is what the resume
    wave replays."""
    bs = kv_pool.k.shape[2]                  # [L, n_blocks + 1, bs, Hkv, hd']
    nb = -(-n_tok // bs)
    bids = torch.as_tensor(np.asarray(list(block_ids)[:nb], np.int64),
                           device=kv_pool.k.device)

    def gather(pool, scale):
        g = pool[:, bids]                    # [L, nb, bs, Hkv, hd']
        g = g.reshape(g.shape[0], nb * bs, *g.shape[3:])[:, :n_tok]
        if kv_pool.bits in (4, 8):
            return _dequantize_kv(g, scale, kv_pool.bits)
        return g.float()

    return (gather(kv_pool.k, kv_pool.k_scale[:, slot]),
            gather(kv_pool.v, kv_pool.v_scale[:, slot]))


def amax_for_scale(scale: np.ndarray, qmax: float,
                   strict: bool = True) -> np.ndarray:
    """Invert :func:`~repro_torch.models.attention.kv_scale` element by
    element: an f32 ``amax`` whose scale is bit-equal to ``scale``.

    The resume wave recalibrates a row's scale from the amax it is given
    (``kv_scale(max(prefix amax, suffix amax))`` with an empty suffix); an
    exact preimage makes the restored scale, and with it every
    re-quantized int, the suspended row's. ``kv_scale`` is one rounding of
    ``amax · f32(1/qmax) + f32(1e-9)``, so the search starts at ``(s −
    1e-9) / f32(1/qmax)`` and walks outwards by f32 ulps. Multiplying by
    ``f32(1/qmax)`` can step over an f32 value, so a scale may have no
    preimage: ``strict`` raises, otherwise the starting point comes back
    and the caller forces the exact scale afterwards (re-quantization
    itself tolerates a few-ulp scale error: ``round(i·(1 ± ε)) == i`` for
    ``|i| <= qmax``)."""
    s = np.asarray(scale, np.float32)
    inv = np.float64(np.float32(1.0 / qmax))
    eps = np.float64(np.float32(1e-9))

    def fwd(a):
        return np.float32(np.float64(a) * inv + eps)

    out = np.empty_like(s)
    for idx, sv in np.ndenumerate(s):
        a0 = np.float32((np.float64(sv) - eps) / inv)
        a = lo = hi = a0
        for _ in range(64):
            if fwd(a) == sv:
                break
            hi = np.nextafter(hi, np.float32(np.inf), dtype=np.float32)
            if fwd(hi) == sv:
                a = hi
                break
            lo = np.nextafter(lo, np.float32(-np.inf), dtype=np.float32)
            if fwd(lo) == sv:
                a = lo
                break
        else:
            if strict:
                raise ValueError(f"no amax preimage for scale {sv!r}")
            a = a0
        out[idx] = a
    return out


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ints(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Per-row lengths as a ``dtype`` tensor on ``device``: host ints
    (numpy, a list) are copied over; a tensor already there is taken as it
    is (no host round trip, so a graph capture can read staged lengths)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _place(dst: torch.Tensor, slot: torch.Tensor, rows: torch.Tensor,
           fill=None) -> None:
    """Write ``rows [B, n, ...]`` into ``dst [B, slots, ...]`` at columns
    ``slot [B, n]``; a column ``>= slots`` goes to an extra sink column that
    is cut off (the reference's dropped writes). With ``fill`` every other
    column becomes ``fill`` (an empty cache's value), whatever ``dst``
    held."""
    eff = dst.shape[1]
    bidx = torch.arange(dst.shape[0], device=dst.device)[:, None]
    if fill is None:
        buf = torch.cat([dst, dst[:, :1]], dim=1)
    else:
        buf = torch.full((dst.shape[0], eff + 1, *dst.shape[2:]), fill,
                         dtype=dst.dtype, device=dst.device)
    buf[bidx, slot.clamp(max=eff)] = rows
    dst.copy_(buf[:, :eff])


def _masked_amax(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Max |x| over real tokens: ``x [B, S, Hkv, D]``, ``keep [B, S]`` →
    ``[B, Hkv]``."""
    a = torch.where(keep[:, :, None, None], x.float().abs(),
                    torch.zeros((), device=x.device))
    return a.amax(dim=(1, 3))


def prefill(params: dict, cfg: ModelConfig, bits_row, batch: dict,
            slots: int, *, kv_bits: int = 16, return_raw_kv: bool = False,
            kv_sched=None, into: Optional[dict] = None):
    """Full-sequence prefill → (last-token logits [B,V], caches).

    Ragged batches (``batch["prompt_len"]``: host ints, or an int tensor
    on the device, read there without a host round trip): each left-padded
    row hands off its KV at per-row *logical* positions, so decode resumes
    at ``pos0 = prompt_len``. Pad slots keep ``token_idx = -1``, and int-KV
    scales are calibrated over real tokens only.

    ``return_raw_kv`` also returns the pre-quantization K/V that the forward
    collected (``(k, v)``, each ``[L, B, S, Hkv, hd]`` in padded column
    coordinates) as a third result: the full-precision masters a prefix
    registry keeps so later continuations replay the cold cache fill.
    ``kv_sched`` (``[L]`` bit-widths, optional) is the precision policy's
    row: the collected K/V, hence the cache, the int-KV scales and the raw
    K/V, are the refined ones.

    On the SSM stack the caches are ``{"ssm": SSMState}``, each row's
    final scan state (``slots`` plays no part), and the raw K/V are
    ``None``. The hybrid stack hands off both. A sliding-window ring holds
    ``eff = min(slots, sliding_window)`` slots and keeps the last ``eff``
    prompt tokens at ``pos % eff``. An encoder-only stack is refused.

    ``into`` (a cache of :func:`init_caches`' shape for this batch, slots
    and ``kv_bits``) takes the hand-off in place of a new cache, and is
    returned: every slot of every row is written (``k``, ``v`` and
    ``token_idx`` whole, the int-KV scales, the SSM rows), so it ends
    bitwise what a new cache would hold, whatever it held before. The
    static path's prefill graph writes its group shape's kept cache so.
    """
    _require_causal(cfg, "prefill")
    hidden, _, collected = forward(params, cfg, bits_row, batch,
                                   collect=True, kv_sched=kv_sched)
    if cfg.family == "ssm":
        caches = {"ssm": _ssm_handoff(*collected, into)}
        logits = _logits(cfg, params, bits_row, hidden[:, -1:])[:, 0]
        return (logits, caches, None) if return_raw_kv else (logits, caches)
    if cfg.family == "hybrid":
        collected, state = collected
    k_all, v_all = collected
    b, s, _ = hidden.shape
    dev = hidden.device
    caches = (init_caches(cfg, b, slots, kv_bits=kv_bits, device=dev)
              if into is None else into)
    if cfg.family == "hybrid":
        caches["ssm"] = _ssm_handoff(*state, into)
    kv = caches["kv"]
    eff = kv.token_idx.shape[-1]
    take = min(eff, s)
    idx = torch.arange(s - take, s, dtype=torch.int64, device=dev)
    plen = batch.get("prompt_len")
    if plen is None:
        pad = torch.zeros((b,), dtype=torch.int64, device=dev)
    else:
        pad = s - _ints(plen, torch.int64, dev)
    pos_t = idx[None, :] - pad[:, None]                    # [B, take] logical
    real = pos_t >= 0
    slot = torch.where(real, pos_t % eff, torch.full_like(pos_t, eff))
    tok_w = torch.where(real, pos_t, torch.full_like(pos_t, -1)).to(torch.int32)
    amask = (torch.arange(s, device=dev)[None] >= pad[:, None])  # [B, S]
    for l in range(cfg.n_layers):
        c = kv.layer(l)
        k_l, v_l = k_all[l], v_all[l]
        if kv_bits in (4, 8):
            qmax = 127.0 if kv_bits == 8 else 7.0
            ks = kv_scale(_masked_amax(k_l, amask), qmax)
            vs = kv_scale(_masked_amax(v_l, amask), qmax)
            kq, vq = _quantize_kv(k_l, ks, kv_bits), _quantize_kv(v_l, vs, kv_bits)
            c.k_scale.copy_(ks)
            c.v_scale.copy_(vs)
        else:
            kq, vq = k_l.to(c.k.dtype), v_l.to(c.v.dtype)
        # the scales of a kv16/kv32 cache stay the ones init_caches made:
        # nothing writes them
        _place(c.k, slot, kq[:, idx], 0)
        _place(c.v, slot, vq[:, idx], 0)
        _place(c.token_idx, slot, tok_w, -1)
    logits = _logits(cfg, params, bits_row, hidden[:, -1:])[:, 0]
    if return_raw_kv:
        return logits, caches, (k_all, v_all)
    return logits, caches


def _ssm_handoff(h_all: torch.Tensor, tails: torch.Tensor,
                 into: Optional[dict]) -> SSMState:
    """The prefill's final scan states as the SSM cache: new, or written
    over ``into["ssm"]``."""
    if into is None:
        return SSMState(h=h_all, conv=tails.float())
    st = into["ssm"]
    st.h.copy_(h_all)
    st.conv.copy_(tails)
    return st


# ---------------------------------------------------------------------------
# continuation prefill (shared prefixes, chunked prefill)
# ---------------------------------------------------------------------------

def forward_extend(params: dict, cfg: ModelConfig, bits_row, batch: dict,
                   prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                   prefix_len: torch.Tensor, kv_sched=None):
    """Backbone over a prompt *suffix* that attends to precomputed prefix
    K/V (:func:`~repro_torch.models.attention.prefix_attention` in every
    layer). Positions are absolute, ``prefix_len + local`` (negative on
    pads), so rope and the causal masks match a cold prefill of the whole
    prompt.

    ``batch``: ``tokens [B, Sb]`` left-padded suffixes and ``prompt_len
    [B]`` their lengths. ``prefix_k``/``prefix_v [L, B, Pp, Hkv, hd]``:
    full-precision prefix K/V, zero past ``prefix_len [B]``. Both lengths
    may be host ints or int tensors on the device (no host round trip).
    Returns
    ``(hidden [B, Sb, d], (k, v) [L, B, Sb, Hkv, hd])``. ``kv_sched``
    refines the fresh suffix K/V only: the prefix K/V were refined when
    they were born.
    """
    _require_ported(cfg)
    assert supports_prefix_sharing(cfg), cfg.family
    eb, _, layer_bits = split_bits(cfg, bits_row)
    tokens = batch["tokens"]
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens, eb)
    b, s = tokens.shape
    slen = _ints(batch["prompt_len"], torch.int32, dev)
    plen = _ints(prefix_len, torch.int32, dev)
    local = (torch.arange(s, dtype=torch.int32, device=dev)[None]
             - (s - slen)[:, None])
    positions = local + plen[:, None]          # absolute; negative on pads
    valid = local >= 0
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=dev))
    x = constrain(x, "dp", None, None)
    sched = _kv_row(cfg, kv_sched)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp, lb = _layer(params["layers"], l), layer_bits[l]
        xin = _norm(cfg, lp["norm_attn"], x)
        q, k, v = _attn_qkv(cfg, lp, xin, lb, positions)
        k, v = _refine(k, v, sched, l)
        attn = prefix_attention(q, prefix_k[l], prefix_v[l], k, v,
                                positions=positions, prefix_len=plen,
                                suffix_valid=valid)
        x = x + qlinear(lp["attn_out"], attn.reshape(b, s, -1),
                        lb[_site_idx(cfg, "attn_out")])
        x = constrain(x, "dp", None, None)
        x = x + _mlp_block(cfg, lp, lb, x)
        ks.append(k)
        vs.append(v)
    x = _norm(cfg, params["norm_f"], x)
    return x, (torch.stack(ks), torch.stack(vs))


def prefill_extend(params: dict, cfg: ModelConfig, bits_row, batch: dict,
                   slots: int, *, kv_bits: int = 16,
                   prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                   prefix_len, prefix_k_amax: Optional[torch.Tensor] = None,
                   prefix_v_amax: Optional[torch.Tensor] = None,
                   return_raw_kv: bool = False, kv_sched=None):
    """Continuation prefill → (last-token logits, dense ``[B, slots]``
    caches): :func:`forward_extend` over the suffix, then the rows a cold
    :func:`prefill` of the whole prompt would hand off — prefix K/V at
    ``0..prefix_len−1``, suffix K/V at ``prefix_len..``, every other slot
    at ``token_idx = −1``.

    At kv8/kv4 each row's scale is :func:`~repro_torch.models.attention.
    kv_scale` of ``max(prefix amax, suffix amax)`` (``prefix_*_amax [L, B,
    Hkv]``, the raw max-|K|/|V| over the real prefix tokens; zeros when
    ``None``): the scale a cold prefill over all real tokens computes, so
    the ints match it. ``return_raw_kv`` also returns the suffix's
    pre-quantization K/V (``[L, B, Sb, Hkv, hd]`` each), which chunked
    prefill keeps as the next chunk's prefix masters.
    """
    hidden, (k_all, v_all) = forward_extend(params, cfg, bits_row, batch,
                                            prefix_k, prefix_v, prefix_len,
                                            kv_sched=kv_sched)
    b, s, _ = hidden.shape
    dev = hidden.device
    caches = init_caches(cfg, b, slots, kv_bits=kv_bits, device=dev)
    kv = caches["kv"]
    eff = slots
    pp = prefix_k.shape[2]
    plen = _ints(prefix_len, torch.int64, dev)
    slen = _ints(batch["prompt_len"], torch.int64, dev)
    ppos = torch.arange(pp, device=dev)[None].expand(b, pp)
    real_p = ppos < plen[:, None]                           # [B, Pp]
    slot_p = torch.where(real_p, ppos, eff)
    tokw_p = torch.where(real_p, ppos, -1).to(torch.int32)
    local = torch.arange(s, device=dev)[None] - (s - slen)[:, None]
    pos_s = local + plen[:, None]                           # [B, Sb] absolute
    real_s = local >= 0
    slot_s = torch.where(real_s, pos_s, eff)
    tokw_s = torch.where(real_s, pos_s, -1).to(torch.int32)
    zeros = torch.zeros((cfg.n_layers, b, cfg.n_kv), device=dev)
    ka_pre = zeros if prefix_k_amax is None else prefix_k_amax
    va_pre = zeros if prefix_v_amax is None else prefix_v_amax
    for l in range(cfg.n_layers):
        c = kv.layer(l)
        k_l, v_l = k_all[l], v_all[l]
        kp_l, vp_l = prefix_k[l], prefix_v[l]
        if kv_bits in (4, 8):
            qmax = 127.0 if kv_bits == 8 else 7.0
            ks = kv_scale(torch.maximum(_masked_amax(k_l, real_s),
                                        ka_pre[l].float()), qmax)
            vs = kv_scale(torch.maximum(_masked_amax(v_l, real_s),
                                        va_pre[l].float()), qmax)
            kq_s, vq_s = (_quantize_kv(k_l, ks, kv_bits),
                          _quantize_kv(v_l, vs, kv_bits))
            kq_p, vq_p = (_quantize_kv(kp_l, ks, kv_bits),
                          _quantize_kv(vp_l, vs, kv_bits))
            c.k_scale.copy_(ks)
            c.v_scale.copy_(vs)
        else:
            kq_s, vq_s = k_l.to(c.k.dtype), v_l.to(c.v.dtype)
            kq_p, vq_p = kp_l.to(c.k.dtype), vp_l.to(c.v.dtype)
        _place(c.k, slot_p, kq_p)
        _place(c.v, slot_p, vq_p)
        _place(c.token_idx, slot_p, tokw_p)
        _place(c.k, slot_s, kq_s)
        _place(c.v, slot_s, vq_s)
        _place(c.token_idx, slot_s, tokw_s)
    logits = _logits(cfg, params, bits_row, hidden[:, -1:])[:, 0]
    if return_raw_kv:
        return logits, caches, (k_all, v_all)
    return logits, caches


def prefix_operands(cfg: ModelConfig, a: int, pp: int, pre, device,
                    out: Optional[tuple] = None) -> tuple:
    """A master-replay continuation's prefix operands for
    :func:`prefill_extend`: ``(prefix_k, prefix_v [L, a, pp, Hkv, hd],
    prefix_k_amax, prefix_v_amax [L, a, Hkv])``, f32, from ``pre`` — one
    ``(n_tok, mk, mv, ka, va)`` per wave row, the f32 masters ``mk``/``mv
    [L, ≥ n_tok, Hkv, hd]`` cut to ``n_tok`` and their raw amaxes (``None``:
    zeros). Every other entry is zero. ``out`` (four tensors of those
    shapes) is zeroed and filled in place; else new tensors are made."""
    if out is None:
        kv = (cfg.n_layers, a, pp, cfg.n_kv, cfg.hd)
        am = (cfg.n_layers, a, cfg.n_kv)
        out = tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                    for shape in (kv, kv, am, am))
    else:
        for x in out:
            x.zero_()
    kpre, vpre, ka, va = out
    for j, (n_tok, mk, mv, ka_j, va_j) in enumerate(pre):
        kpre[:, j, :n_tok] = mk[:, :n_tok]
        vpre[:, j, :n_tok] = mv[:, :n_tok]
        if ka_j is not None:
            ka[:, j], va[:, j] = ka_j, va_j
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params: dict, cfg: ModelConfig, bits_row,
                tokens: torch.Tensor, pos: torch.Tensor, caches: dict,
                row_valid: Optional[torch.Tensor] = None,
                paged_backend: str = "gather", kv_sched=None):
    """One decode step. tokens ``[B,1]``, pos ``[B]`` int32 → (logits [B,V],
    caches), caches updated in place.

    A :class:`PagedKVCache` is read by ``paged_backend``: ``"kernel"``
    attends in place against the pool (the paged-attention kernel; its
    plain version on the CPU), ``"gather"`` builds the dense per-row view.
    A contiguous kv8 cache on ``"kernel"`` is read through the int8-KV
    decode kernel (K4, :func:`~repro_torch.models.attention.
    decode_attention` with ``kernel=True``); ``"gather"`` runs the
    reference's einsum. A ``"kv_view"`` entry (the gather backend of
    :func:`decode_segment`) takes every read and write of the step instead.
    ``kv_sched`` (``[L]`` bit-widths, optional) refines the step's fresh
    K/V before the cache write and the attention read. On the SSM stack
    each layer advances its row of ``caches["ssm"]`` by one token
    (``pos`` and ``kv_sched`` play no part); the hybrid stack does both,
    the SSD step on the attention's normed input. ``row_valid [B]`` (bool,
    optional) marks the rows still generating: the MoE stack drops the
    others from its capacity dispatch, which runs in ``gcd(groups, B)``
    groups; the other families ignore it. An encoder-only stack is
    refused.
    """
    _require_ported(cfg)
    _require_causal(cfg, "decode_step")
    eb, _, layer_bits = split_bits(cfg, bits_row)
    x = embed_lookup(params["embed"], tokens, eb)
    if cfg.family == "ssm":
        for l in range(cfg.n_layers):
            lp = _layer(params["layers"], l)
            x = x + ssm_decode_step(lp["ssm"], _norm(cfg, lp["norm_ssm"], x),
                                    caches["ssm"].layer(l),
                                    *_ssm_bits(cfg, layer_bits[l]), cfg.ssm)
        x = _norm(cfg, params["norm_f"], x)
        return _logits(cfg, params, bits_row, x)[:, 0], caches
    positions = pos[:, None].to(torch.int32)
    b = tokens.shape[0]
    kv, view = caches["kv"], caches.get("kv_view")
    sched = _kv_row(cfg, kv_sched)
    moe_cfg = tv = None
    if cfg.family == "moe":
        moe_cfg = dataclasses.replace(cfg.moe,
                                      groups=math.gcd(cfg.moe.groups, b))
        tv = None if row_valid is None else row_valid[:, None]
    for l in range(cfg.n_layers):
        lp, lb = _layer(params["layers"], l), layer_bits[l]
        xin = _norm(cfg, lp["norm_attn"], x)
        q, k, v = _attn_qkv(cfg, lp, xin, lb, positions)
        k, v = _refine(k, v, sched, l)
        if view is not None:
            c = update_kv_cache(view.layer(l), k, v, pos)
            attn = decode_attention(q, c, pos,
                                    window=cfg.window(c.token_idx.shape[1]))
        elif isinstance(kv, PagedKVCache):
            c = update_paged_kv_cache(kv.layer(l), k, v, pos)
            slots_p = c.block_table.shape[1] * c.k.shape[1]
            if paged_backend == "kernel":
                attn = paged_decode_attention(q, c, pos,
                                              window=cfg.window(slots_p))
            else:
                attn = decode_attention(q, paged_view(c), pos,
                                        window=cfg.window(slots_p))
        else:
            c = update_kv_cache(kv.layer(l), k, v, pos)
            attn = decode_attention(q, c, pos,
                                    window=cfg.window(c.token_idx.shape[1]),
                                    kernel=paged_backend == "kernel")
        attn = qlinear(lp["attn_out"], attn.reshape(b, 1, -1),
                       lb[_site_idx(cfg, "attn_out")])
        if cfg.family == "hybrid":
            out = ssm_decode_step(lp["ssm"], xin, caches["ssm"].layer(l),
                                  *_ssm_bits(cfg, lb), cfg.ssm)
            x = x + _merge(lp, attn, out)
        else:
            x = x + attn
        if cfg.family == "moe":
            x = x + _moe_block(cfg, lp, lb, x, tv, moe_cfg)[0]
        else:
            x = x + _mlp_block(cfg, lp, lb, x)
    x = _norm(cfg, params["norm_f"], x)
    return _logits(cfg, params, bits_row, x)[:, 0], caches


def prequant_decode_weights(params: dict, cfg: ModelConfig, table,
                            dtype: Optional[torch.dtype] = None) -> list:
    """Per-profile weight images, fake-quantized once ahead of the decode
    loop: a list of ``P`` overlay trees parallel to ``params`` whose ``wfq``
    leaves :func:`overlay_params` grafts on.

    Images are kept in the compute dtype — exact, since every paper profile
    puts weights on a grid of at most 8 bits times a power of two, which
    bf16 holds — and **shared** between profiles whose bits coincide (the
    merge plan's one image per distinct spec): the six paper profiles need
    two images, not six. The tied lm_head's image is the embedding image at
    the head's bits, transposed (a view): per-tensor fake-quant commutes
    with the transpose, so this is the reference's in-loop ``fq(w.T)``.

    The MoE stack gets images of its ``router``, ``shared_in`` and
    ``shared_out`` linears; its routed-expert stacks get none, as in the
    reference: :func:`~repro_torch.models.moe.moe_ffn` fake-quantizes them
    on every forward.

    The audio stack's ``embed`` is a linear over frame features, not a
    table, and gets no image (nor in the reference): its forward
    fake-quantizes it per call.

    Native (``wq``) sites pass through untouched. A native tied head gets
    its image here, once per distinct head bits: ``fq(dequantize(embed.wq,
    f32))`` transposed, which is the reference's per-step ``fq(dequantize(
    embed.wq, f32).T)`` hoisted. Every image goes through
    :func:`fake_quant_dynamic` (K5 on the card).
    """
    _require_ported(cfg)
    table = np.asarray(table)
    dev = params["norm_f"]["g"].device
    cd = compute_dtype(dev) if dtype is None else dtype
    images: dict = {}

    def image(name: str, w: torch.Tensor, bits) -> torch.Tensor:
        key = (name, bits)
        if key not in images:
            if isinstance(bits, tuple):         # stacked [L, ...], per layer
                out = torch.empty(w.shape, dtype=cd, device=dev)
                for l, wb in enumerate(bits):
                    out[l] = fake_quant_dynamic(w[l], wb, SIGNED_SYM,
                                                out_dtype=cd)
                images[key] = out
            else:
                images[key] = fake_quant_dynamic(w, bits, SIGNED_SYM,
                                                 out_dtype=cd)
        return images[key]

    lp, emb = params["layers"], params["embed"]
    head_src = None                      # (image name, table) of a tied head
    if cfg.tie_embeddings:
        head_src = (("embed", emb["w"]) if "w" in emb else
                    ("native_head", dequantize(emb["wq"], torch.float32)))
    overlays = []
    for p in range(table.shape[0]):
        eb, hb, lbits = split_bits(cfg, table[p])

        def site(name: str, w: torch.Tensor) -> dict:
            col = lbits[:, _site_idx(cfg, name), 1]
            return {"wfq": image(name, w, tuple(int(x) for x in col))}

        ov: dict = {}
        if "w" in emb and cfg.frontend != "audio":
            ov["embed"] = {"wfq": image("embed", emb["w"], int(eb[1]))}
        if head_src is not None:
            ov["lm_head"] = {"wfq": image(*head_src, int(hb[1])).t()}
        elif "w" in params["lm_head"]:
            ov["lm_head"] = {"wfq": image("lm_head", params["lm_head"]["w"],
                                          int(hb[1]))}
        lov: dict = {}
        if cfg.has_attn and "w" in lp["qkv"]:
            lov["qkv"] = site("qkv", lp["qkv"]["w"])
            lov["attn_out"] = site("attn_out", lp["attn_out"]["w"])
        if cfg.has_mlp and "w" in lp["mlp"]["w_in"]:
            lov["mlp"] = {"w_in": site("mlp_in", lp["mlp"]["w_in"]["w"]),
                          "w_out": site("mlp_out", lp["mlp"]["w_out"]["w"])}
        if cfg.has_ssm and "w" in lp["ssm"]["in_proj"]:
            sp = lp["ssm"]
            lov["ssm"] = {"in_proj": site("ssm_in", sp["in_proj"]["w"]),
                          "out_proj": site("ssm_out", sp["out_proj"]["w"])}
        if cfg.family == "moe" and "w" in lp["moe"]["router"]:
            mp = lp["moe"]
            lov["moe"] = {name: site(name, mp[name]["w"])
                          for name in ("router", "shared_in", "shared_out")
                          if name in mp}
        ov["layers"] = lov
        overlays.append(ov)
    return overlays


def overlay_params(base: dict, overlay: dict) -> dict:
    """Graft a prequant overlay onto the base params tree (``wfq`` leaves
    land next to the float masters; the quantized consumers prefer them)."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            out[k] = overlay_params(base[k], v)
        else:
            out[k] = v
    return out


def _stack_views(views: list) -> KVCache:
    first = views[0]
    return KVCache(*(torch.stack([getattr(v, f) for v in views])
                     for f in ("k", "v", "k_scale", "v_scale", "token_idx")),
                   bits=first.bits)


def _writeback(pool: PagedKVCache, view: KVCache, finish: torch.Tensor) -> None:
    """Fold the gather backend's view back into the pool through the block
    tables, with the tables of rows that finished unmapped first (their
    writes have no future reader). Implemented through the inverse map
    pool block → view block, as in the reference."""
    n_layers, b, nlb = pool.block_table.shape
    nb, bs, dev = pool.n_blocks, pool.k.shape[2], pool.k.device
    bt = torch.where(finish[None, :, None],
                     torch.full((), nb, dtype=torch.int32, device=dev),
                     pool.block_table)
    for l in range(n_layers):
        p, v = pool.layer(l), view.layer(l)
        _, idx = _mapped(bt[l], nb)
        inv = torch.full((nb + 1,), b * nlb, dtype=torch.int64, device=dev)
        inv[idx.reshape(-1)] = torch.arange(b * nlb, device=dev)
        inv = inv[:nb]
        mapped = inv < b * nlb
        src = inv.clamp(max=b * nlb - 1)
        for pl, vl in ((p.k, v.k), (p.v, v.v), (p.token_idx, v.token_idx)):
            g = vl.reshape(b * nlb, bs, *vl.shape[2:])[src]
            keep = mapped.reshape(nb, *([1] * (g.ndim - 1)))
            pl[:nb] = torch.where(keep, g, pl[:nb])
        p.k_scale.copy_(v.k_scale)
        p.v_scale.copy_(v.v_scale)
    pool.block_table.copy_(bt)


def decode_segment(params: dict, cfg: ModelConfig, table, schedule,
                   tok0: torch.Tensor, pos0: torch.Tensor, caches: dict,
                   remaining, prequant: Optional[list] = None,
                   paged_backend: str = "gather",
                   fault_step: Optional[torch.Tensor] = None,
                   kv_table=None):
    """Greedy decode segment of ``len(schedule)`` steps from a mid-generation
    state — the continuous-batching quantum.

    ``tok0 [B]`` is each row's last token (0 for idle rows), ``pos0 [B]``
    its next position, ``remaining [B]`` the tokens it still has to emit
    (0 = retired/free). Rows whose budget runs out freeze: their outputs
    are −1, they feed 0 and keep their position, and (for MoE) each step
    drops them from the expert-capacity dispatch (``row_valid``), so a
    retired or free row never takes a live row's capacity. ``schedule``
    holds the per-step profile ids (host ints).

    Paged pools run one of two backends: ``"gather"`` builds the dense view
    once at entry, steps read and write the view, and the view folds back
    through the tables at exit; ``"kernel"`` attends in place against the
    pool each step and writes through the table. Either way, rows that
    finish inside the segment come back with their tables unmapped. A
    contiguous cache is read in place either way; at kv8 ``"kernel"`` reads
    it through K4 and ``"gather"`` through the reference's einsum
    (:func:`decode_step`).
    ``fault_step [B]`` (optional) poisons a row's logits with NaN at that
    step; the returned ``row_ok [B]`` is a per-row finite check over live
    steps. ``kv_table [P, L]`` (optional) is the precision policy: each
    step refines its fresh K/V by the row of its profile.

    Returns ``(tokens [B, steps], row_ok [B], tok [B], pos [B], caches)``.
    """
    if paged_backend not in ("kernel", "gather"):
        raise ValueError(f"paged_backend must be kernel|gather, got "
                         f"{paged_backend!r}")
    if prequant is None:
        prequant = prequant_decode_weights(params, cfg, table)
    table = np.asarray(table)
    kv_table = None if kv_table is None else np.asarray(kv_table)
    schedule = np.asarray(schedule).reshape(-1)
    dev = tok0.device
    rem = torch.as_tensor(np.asarray(remaining), dtype=torch.int32,
                          device=dev)
    steps = len(schedule)
    paged = isinstance(caches.get("kv"), PagedKVCache)
    use_kernel = paged and paged_backend == "kernel"
    caches = dict(caches)
    if paged and not use_kernel:
        kv = caches["kv"]
        caches["kv_view"] = _stack_views(
            [paged_view(kv.layer(l)) for l in range(cfg.n_layers)])
    tok, pos = tok0.to(torch.int32), pos0.to(torch.int32)
    ok = torch.ones(tok.shape, dtype=torch.bool, device=dev)
    fs = (None if fault_step is None else
          torch.as_tensor(fault_step, dtype=torch.int32, device=dev))
    outs = []
    for i, pid in enumerate(schedule):
        pid = int(pid)
        live = rem > i
        logits, caches = decode_step(
            overlay_params(params, prequant[pid]), cfg, table[pid],
            tok[:, None], pos, caches, row_valid=live,
            paged_backend=paged_backend,
            kv_sched=None if kv_table is None else kv_table[pid])
        if fs is not None:
            logits = torch.where((fs == i)[:, None],
                                 torch.full((), float("nan"), device=dev),
                                 logits)
        ok = ok & (torch.isfinite(logits).all(dim=-1) | ~live)
        nxt = logits.argmax(dim=-1).to(torch.int32)
        outs.append(torch.where(live, nxt, -1))
        tok = torch.where(live, nxt, 0)
        pos = pos + live.to(torch.int32)
    ys = (torch.stack(outs, dim=1) if outs else
          torch.empty((tok.shape[0], 0), dtype=torch.int32, device=dev))
    finish = (rem > 0) & (rem <= steps)
    if use_kernel:
        kv = caches["kv"]
        kv.block_table.masked_fill_(finish[None, :, None], kv.n_blocks)
    elif paged:
        _writeback(caches["kv"], caches.pop("kv_view"), finish)
    return ys, ok, tok, pos, caches


def segment_buffers(batch: int, steps: int, device=None) -> dict:
    """The fixed operands of :func:`segment_step`, for ``batch`` rows and
    segments of up to ``steps`` steps: ``tok``/``pos`` ``[B]`` int32 (the
    carry), ``rem [B]`` int32 (tokens left) and ``fs [B]`` int32 (the fault
    step, −1 = never), the two rows of ``inp [2, B]`` so that one copy
    stages both, ``ok [B]`` bool (the finite check), ``i`` 0-d int32 (the
    device step index) and ``out [B, steps]`` int32 (each step's tokens,
    −1 for frozen rows)."""
    i32 = dict(dtype=torch.int32, device=device)
    inp = torch.zeros((2, batch), **i32)
    inp[1] = -1
    return {"tok": torch.zeros((batch,), **i32),
            "pos": torch.zeros((batch,), **i32),
            "inp": inp, "rem": inp[0], "fs": inp[1],
            "ok": torch.ones((batch,), dtype=torch.bool, device=device),
            "i": torch.zeros((), **i32),
            "out": torch.full((batch, steps), -1, **i32)}


def segment_step(params: dict, cfg: ModelConfig, bits_row, buf: dict,
                 caches: dict, paged_backend: str = "gather",
                 kv_sched=None) -> None:
    """One step of :func:`decode_segment` whose every tensor operand is a
    fixed buffer of :func:`segment_buffers`, so that a CUDA graph of it
    replays any step of any segment: ``live = rem > i`` and the fault
    check ``fs == i`` are device data, the step's tokens land in column
    ``i`` of ``out``, and ``tok``/``pos``/``ok``/``i`` advance in place, as
    do the caches. ``params`` (the profile's overlay), ``bits_row`` and
    ``kv_sched`` are the profile's, so a graph is one profile's step. A
    paged pool is read on the kernel backend; the gather backend's view
    is a per-segment copy and stays with :func:`decode_segment`. On the
    same inputs the tokens are bitwise :func:`decode_segment`'s."""
    if "kv_view" in caches or (isinstance(caches.get("kv"), PagedKVCache)
                               and paged_backend != "kernel"):
        raise ValueError("segment_step reads a paged pool on the kernel "
                         "backend; the gather backend's per-segment view "
                         "belongs to decode_segment")
    i = buf["i"]
    live = buf["rem"] > i
    logits, _ = decode_step(params, cfg, bits_row, buf["tok"][:, None],
                            buf["pos"], caches, row_valid=live,
                            paged_backend=paged_backend, kv_sched=kv_sched)
    logits = torch.where((buf["fs"] == i)[:, None],
                         torch.full((), float("nan"), device=logits.device),
                         logits)
    buf["ok"].logical_and_(torch.isfinite(logits).all(dim=-1) | ~live)
    nxt = logits.argmax(dim=-1).to(torch.int32)
    buf["out"].index_copy_(1, i.reshape(1).long(),
                           torch.where(live, nxt, -1)[:, None])
    buf["tok"].copy_(torch.where(live, nxt, 0))
    buf["pos"].add_(live.to(torch.int32))
    i.add_(1)


def decode_many(params: dict, cfg: ModelConfig, table, schedule,
                logits0: torch.Tensor, pos0: torch.Tensor, caches: dict,
                row_budget=None, prequant: Optional[list] = None,
                paged_backend: str = "gather", kv_table=None):
    """Greedy decode of ``len(schedule)`` tokens from prefill logits (port
    of the reference's fused ``decode_many``): ``tokens[:, 0]`` is the
    argmax of ``logits0 [B, V]`` (produced under profile ``schedule[0]``),
    then :func:`decode_segment` runs ``schedule[1:]`` from ``pos0 [B]``
    with ``row_budget − 1`` tokens left per row. ``row_budget [B]``
    (default: every step) freezes a row at its budget: its later tokens
    are −1. ``kv_table [P, L]`` is the precision policy (its rows for the
    decode steps; the caller's prefill took ``schedule[0]``'s). Returns
    ``(tokens [B, steps] int32, pids [steps], caches)``; ``pids`` is the
    schedule, the realized per-step profile trace."""
    schedule = np.asarray(schedule, np.int32).reshape(-1)
    steps = len(schedule)
    b = logits0.shape[0]
    budget = (np.full((b,), steps, np.int32) if row_budget is None
              else np.asarray(row_budget, np.int32))
    live0 = torch.as_tensor(budget > 0, device=logits0.device)
    tok0 = logits0.argmax(dim=-1).to(torch.int32)
    out0 = torch.where(live0, tok0, -1)
    ys, _, _, _, caches = decode_segment(
        params, cfg, table, schedule[1:], torch.where(live0, tok0, 0), pos0,
        caches, budget - 1, prequant=prequant, paged_backend=paged_backend,
        kv_table=kv_table)
    return torch.cat([out0[:, None], ys], dim=1), schedule, caches


# ---------------------------------------------------------------------------
# speculative decoding: n-gram drafter, W-token verify, spec segment
# ---------------------------------------------------------------------------

def ngram_propose(hist: torch.Tensor, tok: torch.Tensor, k: int,
                  vocab: int) -> torch.Tensor:
    """Self-speculative n-gram drafter: longest-suffix match over the row's
    own history.

    ``hist [B, Hn]`` holds each row's most recent tokens (−1 = empty, pads
    on the left only) with the *current* token last; ``tok [B]`` is that
    token. Each earlier position ``j`` is scored by how long a suffix of
    the current context it matches (up to a trigram; a (d+1)-gram match
    beats any d-gram match, the most recent position wins ties), and the
    ``k`` tokens that followed the best match are proposed — extended
    periodically when the match sits closer than ``k`` to the end. Rows
    with no match repeat the current token. Integer-only, no host sync.
    Returns ``[B, k]`` int32.
    """
    b, hn = hist.shape
    dev = hist.device
    if not k:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    h = hist.to(torch.int32)
    cur = tok.to(torch.int32)
    depth = min(3, hn - 1)
    j_idx = torch.arange(hn - 1, device=dev)[None]           # [1, hn-1]
    score = torch.zeros((b, hn - 1), dtype=torch.int32, device=dev)
    run = torch.ones((b, hn - 1), dtype=torch.bool, device=dev)
    for d in range(depth):
        tgt = h[:, hn - 1 - d][:, None]                       # suffix token
        cand = torch.where(j_idx - d >= 0,
                           h.gather(1, (j_idx - d).clamp(min=0)
                                    .expand(b, -1)), -2)
        run = run & (cand == tgt) & (tgt >= 0)
        score = score + (1 << d) * run.to(torch.int32)
    best_j = (score * hn + j_idx).argmax(dim=1)
    matched = score.amax(dim=1) > 0
    period = (hn - 1 - best_j).clamp(min=1)
    offs = torch.arange(k, device=dev)[None]                  # [1, k]
    idx = best_j[:, None] + 1 + torch.remainder(offs, period[:, None])
    prop = h.gather(1, idx.clamp(max=hn - 1))
    return torch.where(matched[:, None] & (prop >= 0), prop, cur[:, None])


def decode_step_spec(params: dict, cfg: ModelConfig, bits_row,
                     tokens: torch.Tensor, pos: torch.Tensor, caches: dict,
                     paged_backend: str = "gather"):
    """W-token draft/verify forward. tokens ``[B, W]`` (``tokens[:, j]`` at
    position ``pos + j``) → ``(logits [B, W, V], caches, (k_ladders,
    v_ladders))`` with ladders ``[L, B, W, Hkv]``; caches updated in place.

    The W-wide twin of :func:`decode_step` for the stacks
    :func:`supports_speculation` admits. All W positions are written before
    attention runs, and the committed int8 scales are left untouched: the
    caller commits the ladders at the accepted count
    (:func:`decode_segment_spec`). Cache branches as in
    :func:`decode_step`: a ``"kv_view"`` entry takes every read and write;
    a paged pool attends in place (``"kernel"``, the window kernel) or
    through the dense view (``"gather"``).
    """
    _require_ported(cfg)
    assert supports_speculation(cfg), cfg.family
    eb, _, layer_bits = split_bits(cfg, bits_row)
    x = embed_lookup(params["embed"], tokens, eb)
    b, w = tokens.shape
    positions = (pos[:, None] + torch.arange(w, dtype=torch.int32,
                                             device=pos.device)[None])
    kv, view = caches["kv"], caches.get("kv_view")
    klads, vlads = [], []
    for l in range(cfg.n_layers):
        lp, lb = _layer(params["layers"], l), layer_bits[l]
        xin = _norm(cfg, lp["norm_attn"], x)
        q, k, v = _attn_qkv(cfg, lp, xin, lb, positions)
        if view is not None:
            c, klad, vlad = update_kv_cache_window(view.layer(l), k, v, pos)
            attn = decode_attention_window(
                q, c, pos, klad, vlad, window=cfg.window(c.token_idx.shape[1]))
        elif isinstance(kv, PagedKVCache):
            c, klad, vlad = update_paged_kv_cache_window(kv.layer(l), k, v,
                                                         pos)
            slots_p = c.block_table.shape[1] * c.k.shape[1]
            if paged_backend == "kernel":
                attn = paged_decode_attention_window(
                    q, c, pos, klad, vlad, window=cfg.window(slots_p))
            else:
                attn = decode_attention_window(
                    q, paged_view(c), pos, klad, vlad,
                    window=cfg.window(slots_p))
        else:
            c, klad, vlad = update_kv_cache_window(kv.layer(l), k, v, pos)
            attn = decode_attention_window(
                q, c, pos, klad, vlad, window=cfg.window(c.token_idx.shape[1]))
        klads.append(klad)
        vlads.append(vlad)
        x = x + qlinear(lp["attn_out"], attn.reshape(b, w, -1),
                        lb[_site_idx(cfg, "attn_out")])
        x = x + _mlp_block(cfg, lp, lb, x)
    x = _norm(cfg, params["norm_f"], x)
    logits = _logits(cfg, params, bits_row, x)               # [B, W, V]
    return logits, caches, (torch.stack(klads), torch.stack(vlads))


def _commit_window_scales(kv, k_ladders: torch.Tensor,
                          v_ladders: torch.Tensor, m: torch.Tensor,
                          w: int) -> None:
    """Commit, in place, the ladder entry of each row's last delivered
    position as its int8 scale (``kv`` stacked, scales ``[L, B, Hkv]``;
    ladders ``[L, B, W, Hkv]``; ``m [B]`` delivered counts). Rows with
    ``m == 0`` keep their scale: a frozen row's junk must never move the
    scale its ints were written under."""
    if kv.bits != 8:
        return
    n_layers, b, _, hkv = k_ladders.shape
    idx = (m.long() - 1).clamp(0, w - 1)[None, :, None, None]
    idx = idx.expand(n_layers, b, 1, hkv)
    keep = (m >= 1)[None, :, None]
    kv.k_scale.copy_(torch.where(keep, k_ladders.gather(2, idx)[:, :, 0],
                                 kv.k_scale))
    kv.v_scale.copy_(torch.where(keep, v_ladders.gather(2, idx)[:, :, 0],
                                 kv.v_scale))


def _spec_window(params: dict, cfg: ModelConfig, bits_row, caches: dict,
                 hist, tok, pos, rem, qta, son, fs, i, draft_k: int,
                 paged_backend: str, draft_fn=None, override=None):
    """One draft/verify window of :func:`decode_segment_spec` (and of
    :func:`segment_spec_step`): propose ``draft_k`` tokens per row (the
    drafter over ``hist``/``tok``, ``override`` entries ``>= 0`` forced),
    verify ``[tok, d_1..d_k]`` in one forward at ``pos``, poison the
    window of rows whose fault index ``fs`` is ``i``, and commit each
    row's int8 scales at its delivered count. ``i`` is the window index,
    a host int or a 0-d device tensor. Returns ``(g [B, W], m [B], fin
    [B])``: the greedy chain, the delivered counts (0 for rows that are
    not live) and the window's finite check (True for rows not live)."""
    w = draft_k + 1
    live = (rem > 0) & (qta > 0)
    if draft_fn is not None:
        prop = draft_fn(hist, tok).to(torch.int32)
    else:
        prop = ngram_propose(hist, tok, draft_k, cfg.vocab)
    if override is not None:
        prop = torch.where(override >= 0, override, prop)
    feed = torch.cat([tok[:, None], prop], dim=1)              # [B, W]
    feed = torch.where(live[:, None], feed, 0)
    logits, caches, (klads, vlads) = decode_step_spec(
        params, cfg, bits_row, feed, pos, caches, paged_backend=paged_backend)
    # a fault poisons the whole verify window after the KV writes
    logits = torch.where((fs == i)[:, None, None],
                         torch.full((), float("nan"), device=logits.device),
                         logits)
    fin = torch.isfinite(logits).all(dim=2).all(dim=1) | ~live
    g = logits.argmax(dim=-1).to(torch.int32)                   # [B, W]
    if draft_k:
        match = (prop == g[:, :draft_k]).to(torch.int32)
        acc = match.cumprod(dim=1).sum(dim=1).to(torch.int32)
    else:
        acc = torch.zeros_like(rem)
    one = torch.ones_like(rem)
    m = torch.where(son, torch.minimum(torch.minimum(acc + 1, rem), qta),
                    torch.minimum(torch.minimum(one, rem), qta))
    m = torch.where(live, m, 0).to(torch.int32)
    _commit_window_scales(caches["kv_view"] if "kv_view" in caches
                          else caches["kv"], klads, vlads, m, w)
    return g, m, fin


def decode_segment_spec(params: dict, cfg: ModelConfig, table, schedule,
                        tok0: torch.Tensor, pos0: torch.Tensor, caches: dict,
                        remaining, quota=None, hist0=None, spec_on=None,
                        prequant: Optional[list] = None,
                        paged_backend: str = "gather",
                        fault_step=None, draft_k: int = 4,
                        draft_override=None, draft_fn=None):
    """Speculative decode segment: ``len(schedule)`` draft/verify windows.

    Each window proposes ``draft_k`` tokens per row (:func:`ngram_propose`
    over the history, or ``draft_fn(hist, tok) -> [B, draft_k]``), feeds
    ``[tok, d_1..d_k]`` (``W = draft_k + 1``) through one verify forward
    (:func:`decode_step_spec`), and advances each row by its **delivered**
    count ``m = min(accepted + 1, remaining, quota)``: ``accepted`` is the
    length of the prefix where the drafts equal the greedy argmax chain,
    and position ``accepted`` adds the bonus token, so every delivered
    token is the token greedy decode would emit. Rejected positions need
    no rollback: the next window's writes cover their slots before any
    query reads them, and their amaxes never reach the committed scales
    (:func:`_commit_window_scales`).

    ``quota [B]`` caps the segment's delivered tokens per row; ``spec_on
    [B]`` False clamps a row to ``m <= 1``; ``hist0 [B, Hn]`` is the
    drafter's history (default: 32 slots holding only ``tok0``);
    ``fault_step [B]`` poisons a row's whole ``[W, V]`` verify logits at
    that window, and ``row_ok`` finite-checks every live window;
    ``draft_override [B, n_iter, draft_k]`` (entries ``>= 0``) forces
    proposals. The loop makes no host sync: ``m`` stays on the device.
    Paged pools run the backends of :func:`decode_segment`, and rows that
    finish inside the segment come back with their tables unmapped.

    Returns ``(tokens [B, n_iter, W], delivered [B, n_iter], row_ok [B],
    tok [B], pos [B], caches)``; window ``i`` delivered
    ``tokens[:, i, :delivered[:, i]]``, the rest is −1.
    """
    if paged_backend not in ("kernel", "gather"):
        raise ValueError(f"paged_backend must be kernel|gather, got "
                         f"{paged_backend!r}")
    if prequant is None:
        prequant = prequant_decode_weights(params, cfg, table)
    table = np.asarray(table)
    schedule = np.asarray(schedule).reshape(-1)
    n_iter = len(schedule)
    dev = tok0.device
    b = tok0.shape[0]
    w = draft_k + 1

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    rem0 = i32(remaining)
    rem = rem0
    qta = (torch.full((b,), np.iinfo(np.int32).max // 2, dtype=torch.int32,
                      device=dev) if quota is None else i32(quota))
    son = (torch.ones((b,), dtype=torch.bool, device=dev) if spec_on is None
           else torch.as_tensor(spec_on, dtype=torch.bool, device=dev))
    fs = (torch.full((b,), -1, dtype=torch.int32, device=dev)
          if fault_step is None else i32(fault_step))
    tok, pos = tok0.to(torch.int32), pos0.to(torch.int32)
    if hist0 is None:
        hist = torch.full((b, 32), -1, dtype=torch.int32, device=dev)
        hist[:, -1] = tok
    else:
        hist = i32(hist0)
    dov = (None if draft_override is None
           else i32(draft_override).permute(1, 0, 2))        # [n_iter, B, k]
    paged = isinstance(caches.get("kv"), PagedKVCache)
    use_kernel = paged and paged_backend == "kernel"
    caches = dict(caches)
    if paged and not use_kernel:
        kv = caches["kv"]
        caches["kv_view"] = _stack_views(
            [paged_view(kv.layer(l)) for l in range(cfg.n_layers)])
    wj = torch.arange(w, device=dev)[None]
    hj = torch.arange(hist.shape[1], device=dev)[None]
    ok = torch.ones((b,), dtype=torch.bool, device=dev)
    outs, ms = [], []
    for i, pid in enumerate(schedule):
        pid = int(pid)
        g, m, fin = _spec_window(
            overlay_params(params, prequant[pid]), cfg, table[pid], caches,
            hist, tok, pos, rem, qta, son, fs, i, draft_k, paged_backend,
            draft_fn, None if dov is None else dov[i])
        ok = ok & fin
        outs.append(torch.where(wj < m[:, None], g, -1))
        ms.append(m)
        last = g.gather(1, (m.long() - 1).clamp(0, w - 1)[:, None])[:, 0]
        tok = torch.where(m >= 1, last, tok)
        # slide the drafter's history past the delivered tokens only
        hist = torch.cat([hist, g], dim=1).gather(1, m.long()[:, None] + hj)
        pos, rem, qta = pos + m, rem - m, qta - m
    ys = (torch.stack(outs, dim=1) if outs else
          torch.empty((b, 0, w), dtype=torch.int32, device=dev))
    delivered = (torch.stack(ms, dim=1) if ms else
                 torch.empty((b, 0), dtype=torch.int32, device=dev))
    finish = (rem0 > 0) & (rem <= 0)
    if use_kernel:
        kv = caches["kv"]
        kv.block_table.masked_fill_(finish[None, :, None], kv.n_blocks)
    elif paged:
        _writeback(caches["kv"], caches.pop("kv_view"), finish)
    return ys, delivered, ok, tok, pos, caches


def segment_spec_buffers(batch: int, n_iter: int, w: int, hist: int,
                         device=None) -> dict:
    """The fixed operands of :func:`segment_spec_step`, for ``batch`` rows,
    segments of up to ``n_iter`` windows of ``w`` tokens and a drafter
    history of ``hist`` tokens: the carries ``tok``/``pos`` ``[B]`` int32;
    one flat int32 block ``inp`` that one host→device copy stages per
    segment, viewed as the history ``hist [B, Hn]`` (contiguous), then
    ``rem`` (tokens left, a carry), ``rem0`` (the staged ``remaining``,
    read at the segment's end), ``fs`` (the fault window, −1 = never),
    ``qta`` (quota left, a carry) and ``son`` (1 = the row speculates),
    each ``[B]``; ``ok [B]`` bool (the finite check), ``i`` 0-d int32 (the
    device window index), ``out [B, n_iter, w]`` int32 (each window's
    delivered tokens, −1 past the delivered count) and ``ms [B, n_iter]``
    int32 (the delivered counts)."""
    i32 = dict(dtype=torch.int32, device=device)
    inp = torch.zeros(((5 + hist) * batch,), **i32)
    n = hist * batch
    buf = {"inp": inp, "hist": inp[:n].view(batch, hist)}
    for j, name in enumerate(("rem", "rem0", "fs", "qta", "son")):
        buf[name] = inp[n + j * batch:n + (j + 1) * batch]
    buf["hist"].fill_(-1)
    buf["fs"].fill_(-1)
    buf.update(tok=torch.zeros((batch,), **i32),
               pos=torch.zeros((batch,), **i32),
               ok=torch.ones((batch,), dtype=torch.bool, device=device),
               i=torch.zeros((), **i32),
               out=torch.full((batch, n_iter, w), -1, **i32),
               ms=torch.zeros((batch, n_iter), **i32))
    return buf


def segment_spec_step(params: dict, cfg: ModelConfig, bits_row, buf: dict,
                      caches: dict, paged_backend: str = "gather",
                      draft_k: int = 4, draft_fn=None) -> None:
    """One window of :func:`decode_segment_spec` whose every tensor operand
    is a fixed buffer of :func:`segment_spec_buffers`, so that a CUDA graph
    of it replays any window of any segment: ``live``, the fault check
    ``fs == i``, the drafter, the accept count, the committed int8 scales
    and the history slide read device data, the window's tokens and
    delivered counts land in column ``i`` of ``out``/``ms``, and
    ``tok``/``pos``/``rem``/``qta``/``hist``/``ok``/``i`` advance in place,
    as do the caches. ``params`` (the profile's overlay) and ``bits_row``
    are the profile's, so a graph is one profile's window. A paged pool is
    read on the kernel backend; the gather backend's view is a per-segment
    copy and stays with :func:`decode_segment_spec`. On the same inputs the
    tokens, delivered counts, finite check, carries, scales and caches are
    bitwise :func:`decode_segment_spec`'s."""
    if "kv_view" in caches or (isinstance(caches.get("kv"), PagedKVCache)
                               and paged_backend != "kernel"):
        raise ValueError("segment_spec_step reads a paged pool on the kernel "
                         "backend; the gather backend's per-segment view "
                         "belongs to decode_segment_spec")
    w = draft_k + 1
    i, tok, hist = buf["i"], buf["tok"], buf["hist"]
    rem, qta = buf["rem"], buf["qta"]
    g, m, fin = _spec_window(params, cfg, bits_row, caches, hist, tok,
                             buf["pos"], rem, qta, buf["son"] != 0, buf["fs"],
                             i, draft_k, paged_backend, draft_fn)
    buf["ok"].logical_and_(fin)
    col = i.reshape(1).long()
    wj = torch.arange(w, device=g.device)[None]
    buf["out"].index_copy_(1, col, torch.where(wj < m[:, None], g, -1)[:, None])
    buf["ms"].index_copy_(1, col, m[:, None])
    last = g.gather(1, (m.long() - 1).clamp(0, w - 1)[:, None])[:, 0]
    tok.copy_(torch.where(m >= 1, last, tok))
    # the slide allocates; its result is copied back into the fixed buffer
    hj = torch.arange(hist.shape[1], device=g.device)[None]
    hist.copy_(torch.cat([hist, g], dim=1).gather(1, m.long()[:, None] + hj))
    buf["pos"].add_(m)
    rem.sub_(m)
    qta.sub_(m)
    i.add_(1)
