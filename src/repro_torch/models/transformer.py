"""LM assembly for the port (port of ``repro/models/transformer.py``, dense
family).

Parameters and caches keep the reference's stacked ``[L, ...]`` layout, so
conversion is one to one and the per-layer loop indexes layer ``l``. The
bits table is host data: ``bits_row`` is a numpy ``[2 + L·S, 2]`` array and
each site's ``(a_bits, w_bits)`` reaches the quantizers as Python ints.
Caches are updated in place.

Public entry points: ``init_params``, ``quant_layer_names``, ``forward``,
``prefill``, ``decode_step``, ``prequant_decode_weights``,
``overlay_params``, ``init_caches``, ``init_paged_caches``,
``decode_segment``, ``decode_many``, and for speculative decoding
``ngram_propose``, ``decode_step_spec`` and ``decode_segment_spec``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .attention import (KVCache, PagedKVCache, _mapped, _quantize_kv,
                        decode_attention, decode_attention_window,
                        gqa_attention, init_kv_cache, init_paged_kv_cache,
                        kv_scale, paged_decode_attention,
                        paged_decode_attention_window, paged_view,
                        stack_layers, update_kv_cache, update_kv_cache_window,
                        update_paged_kv_cache, update_paged_kv_cache_window)
from .layers import (SIGNED_SYM, embed_lookup, init_embed, init_linear,
                     init_norm, qlinear, rms_norm)
from .mlp import init_mlp, mlp
from .rotary import apply_rope
from repro_torch.core.quantizers import QTensor, dequantize, fake_quant_dynamic
from repro_torch.runtime import compute_dtype

__all__ = ["ModelConfig", "sites", "quant_layer_names", "split_bits",
           "init_params", "param_count", "forward", "prefill", "decode_step",
           "prequant_decode_weights", "overlay_params", "paged_block_size",
           "init_caches", "init_paged_caches", "cache_bytes",
           "supports_prefix_sharing", "supports_speculation",
           "decode_segment", "decode_many", "ngram_propose",
           "decode_step_spec", "decode_segment_spec"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's config, field for field (the port implements the
    dense family; ``moe``/``ssm`` stay ``None``)."""

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

    def window(self, skv: int) -> int:
        return self.sliding_window if self.sliding_window else skv + 1


def _require_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.sliding_window or cfg.mrope
            or cfg.norm != "rms" or not cfg.causal or cfg.frontend):
        raise NotImplementedError(
            f"{cfg.name}: only the dense full-attention family is ported")


_SITES = {"dense": ("qkv", "attn_out", "mlp_in", "mlp_out")}
_GLOBAL_SITES = ("embed", "lm_head")


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
    norms at one. Layers are drawn stacked ``[L, ...]`` from ``gen``, which
    must live on ``device``."""
    _require_dense(cfg)
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    layers = {
        "qkv": init_linear(gen, d, (cfg.n_heads + 2 * cfg.n_kv) * hd,
                           bias=cfg.qkv_bias, layers=L, device=device),
        "attn_out": init_linear(gen, cfg.n_heads * hd, d, layers=L,
                                device=device),
        "norm_attn": init_norm(d, layers=L, device=device),
        "mlp": init_mlp(gen, d, cfg.d_ff, gated=cfg.act == "silu", layers=L,
                        device=device),
        "norm_mlp": init_norm(d, layers=L, device=device),
    }
    p = {"layers": layers, "norm_f": init_norm(d, device=device),
         "embed": init_embed(gen, cfg.vocab, d, device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, d, cfg.vocab, scale=0.02,
                                   device=device)
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


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.layer(l)
    return tree[l]


# ---------------------------------------------------------------------------
# layer body
# ---------------------------------------------------------------------------

def _attn_qkv(cfg: ModelConfig, lp: dict, x: torch.Tensor, lb,
              positions: torch.Tensor):
    """Project + rope. Returns q [B,S,H,hd], k/v [B,S,Hkv,hd]."""
    b, s, _ = x.shape
    hd = cfg.hd
    qkv = qlinear(lp["qkv"], x, lb[_site_idx(cfg, "qkv")])
    q, k, v = torch.split(
        qkv, [cfg.n_heads * hd, cfg.n_kv * hd, cfg.n_kv * hd], dim=-1)
    q = apply_rope(q.reshape(b, s, cfg.n_heads, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, cfg.n_kv, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv, hd)


def _mlp_block(cfg: ModelConfig, lp: dict, lb, x: torch.Tensor):
    return mlp(lp["mlp"], rms_norm(lp["norm_mlp"], x),
               lb[_site_idx(cfg, "mlp_in")], lb[_site_idx(cfg, "mlp_out")],
               gated=cfg.act == "silu", act=cfg.act)


def _embed_inputs(cfg: ModelConfig, params: dict, bits_row, batch: dict):
    """Tokens → hidden states, positions and validity. ``prompt_len`` marks
    left-padded ragged rows: per-row positions count real tokens from 0 and
    pad embeddings are zeroed."""
    eb, _, _ = split_bits(cfg, bits_row)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, eb)
    b, s = tokens.shape
    ar = torch.arange(s, dtype=torch.int32, device=tokens.device)
    plen = batch.get("prompt_len")
    if plen is None:
        return x, ar[None].expand(b, s), None
    pad = s - torch.as_tensor(plen, dtype=torch.int32, device=tokens.device)
    positions = ar[None] - pad[:, None]
    valid = positions >= 0
    x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    return x, positions, valid


def forward(params: dict, cfg: ModelConfig, bits_row, batch: dict,
            collect: bool = False):
    """Backbone over a full sequence → (hidden [B,S,d], aux, collected);
    ``collected`` is ``(k, v)``, each ``[L, B, S, Hkv, hd]``, with
    ``collect`` (the prefill → cache handoff)."""
    _require_dense(cfg)
    x, positions, valid = _embed_inputs(cfg, params, bits_row, batch)
    _, _, layer_bits = split_bits(cfg, bits_row)
    s = x.shape[1]
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp, lb = _layer(params["layers"], l), layer_bits[l]
        xin = rms_norm(lp["norm_attn"], x)
        q, k, v = _attn_qkv(cfg, lp, xin, lb, positions)
        attn = gqa_attention(q, k, v, causal=cfg.causal, window=cfg.window(s),
                             block_k=cfg.attn_block_k, kv_valid=valid)
        x = x + qlinear(lp["attn_out"], attn.reshape(*attn.shape[:2], -1),
                        lb[_site_idx(cfg, "attn_out")])
        x = x + _mlp_block(cfg, lp, lb, x)
        if collect:
            ks.append(k)
            vs.append(v)
    x = rms_norm(params["norm_f"], x)
    aux = torch.zeros((), device=x.device)
    collected = (torch.stack(ks), torch.stack(vs)) if collect else ()
    return x, aux, collected


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


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kv_dtype(kv_bits: int) -> torch.dtype:
    return torch.float32 if kv_bits == 32 else torch.bfloat16


def init_caches(cfg: ModelConfig, batch: int, slots: int, *,
                kv_bits: int = 16, device=None) -> dict:
    """Contiguous decode caches, stacked ``[L, ...]``."""
    one = init_kv_cache(batch, slots, cfg.n_kv, cfg.hd, bits=kv_bits,
                        dtype=_kv_dtype(kv_bits), device=device)
    return {"kv": stack_layers(one, cfg.n_layers)}


def paged_block_size(cfg: ModelConfig, slots: int, block_size: int) -> int:
    """Largest block size ≤ ``block_size`` compatible with ``cfg`` (a
    divisor of the sliding window where there is one)."""
    bs = max(1, int(block_size))
    if cfg.sliding_window:
        eff = min(slots, cfg.sliding_window)
        while eff % bs and bs > 1:
            bs -= 1
    return bs


def init_paged_caches(cfg: ModelConfig, batch: int, slots: int, *,
                      kv_bits: int = 16, block_size: int = 16,
                      pool_blocks: Optional[int] = None,
                      device=None) -> dict:
    """Paged decode caches: ``pool_blocks`` physical blocks of
    ``block_size`` tokens shared by ``batch`` rows, each with a
    ``[ceil(slots / block_size)]`` block table; ``None`` provisions the
    contiguous footprint."""
    bs = paged_block_size(cfg, slots, block_size)
    n_lblk = -(-slots // bs)
    nb = batch * n_lblk if pool_blocks is None else int(pool_blocks)
    one = init_paged_kv_cache(batch, nb, bs, n_lblk, cfg.n_kv, cfg.hd,
                              bits=kv_bits, dtype=_kv_dtype(kv_bits),
                              device=device)
    return {"kv": stack_layers(one, cfg.n_layers)}


def cache_bytes(caches) -> int:
    """Device bytes held by a cache tree (pools, tables, scales)."""
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
    has_attn = cfg.family in ("dense", "moe", "hybrid", "vlm", "audio")
    has_ssm = cfg.family in ("ssm", "hybrid")
    return (has_attn and not has_ssm and cfg.family != "moe"
            and not cfg.sliding_window and cfg.causal)


def supports_speculation(cfg: ModelConfig, kv_bits: int = 16) -> bool:
    """Whether draft/verify speculative decoding is exact for this stack:
    the prefix-sharing requirements (a rejected draft must be rollable
    back, and a ring could wrap a speculative tail onto live slots) plus
    kv16/kv8 — the packed int4 cache has no per-query dequant ladder."""
    return supports_prefix_sharing(cfg) and kv_bits in (8, 16)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params: dict, cfg: ModelConfig, bits_row, batch: dict,
            slots: int, *, kv_bits: int = 16):
    """Full-sequence prefill → (last-token logits [B,V], caches).

    Ragged batches (``batch["prompt_len"]``, host ints): each left-padded
    row hands off its KV at per-row *logical* positions, so decode resumes
    at ``pos0 = prompt_len``. Pad slots keep ``token_idx = -1``, and int-KV
    scales are calibrated over real tokens only.
    """
    hidden, _, (k_all, v_all) = forward(params, cfg, bits_row, batch,
                                        collect=True)
    b, s, _ = hidden.shape
    dev = hidden.device
    caches = init_caches(cfg, b, slots, kv_bits=kv_bits, device=dev)
    kv = caches["kv"]
    eff = slots
    take = min(eff, s)
    idx = torch.arange(s - take, s, dtype=torch.int64, device=dev)
    plen = batch.get("prompt_len")
    if plen is None:
        pad = torch.zeros((b,), dtype=torch.int64, device=dev)
    else:
        pad = s - torch.as_tensor(np.asarray(plen), dtype=torch.int64,
                                  device=dev)
    pos_t = idx[None, :] - pad[:, None]                    # [B, take] logical
    real = pos_t >= 0
    slot = torch.where(real, pos_t % eff, torch.full_like(pos_t, eff))
    tok_w = torch.where(real, pos_t, torch.full_like(pos_t, -1)).to(torch.int32)
    amask = (torch.arange(s, device=dev)[None] >= pad[:, None])  # [B, S]
    bidx = torch.arange(b, device=dev)[:, None]

    def place(dst: torch.Tensor, rows: torch.Tensor) -> None:
        """Write ``rows [B, take, ...]`` at ``slot``; pad columns go to an
        extra sink slot that is cut off (the reference's dropped writes)."""
        buf = torch.cat([dst, dst[:, :1]], dim=1)
        buf[bidx, slot] = rows
        dst.copy_(buf[:, :eff])

    for l in range(cfg.n_layers):
        c = kv.layer(l)
        k_l, v_l = k_all[l], v_all[l]
        if kv_bits in (4, 8):
            qmax = 127.0 if kv_bits == 8 else 7.0
            zero = torch.zeros((), device=dev)
            ka = torch.where(amask[:, :, None, None], k_l.float().abs(), zero)
            va = torch.where(amask[:, :, None, None], v_l.float().abs(), zero)
            ks = kv_scale(ka.amax(dim=(1, 3)), qmax)
            vs = kv_scale(va.amax(dim=(1, 3)), qmax)
            kq, vq = _quantize_kv(k_l, ks, kv_bits), _quantize_kv(v_l, vs, kv_bits)
            c.k_scale.copy_(ks)
            c.v_scale.copy_(vs)
        else:
            kq, vq = k_l.to(c.k.dtype), v_l.to(c.v.dtype)
        place(c.k, kq[:, idx])
        place(c.v, vq[:, idx])
        place(c.token_idx, tok_w)
    logits = _logits(cfg, params, bits_row, hidden[:, -1:])[:, 0]
    return logits, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params: dict, cfg: ModelConfig, bits_row,
                tokens: torch.Tensor, pos: torch.Tensor, caches: dict,
                paged_backend: str = "gather"):
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
    """
    _require_dense(cfg)
    eb, _, layer_bits = split_bits(cfg, bits_row)
    x = embed_lookup(params["embed"], tokens, eb)
    positions = pos[:, None].to(torch.int32)
    b = tokens.shape[0]
    kv, view = caches["kv"], caches.get("kv_view")
    for l in range(cfg.n_layers):
        lp, lb = _layer(params["layers"], l), layer_bits[l]
        xin = rms_norm(lp["norm_attn"], x)
        q, k, v = _attn_qkv(cfg, lp, xin, lb, positions)
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
        x = x + qlinear(lp["attn_out"], attn.reshape(b, 1, -1),
                        lb[_site_idx(cfg, "attn_out")])
        x = x + _mlp_block(cfg, lp, lb, x)
    x = rms_norm(params["norm_f"], x)
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

    Native (``wq``) sites pass through untouched. A native tied head gets
    its image here, once per distinct head bits: ``fq(dequantize(embed.wq,
    f32))`` transposed, which is the reference's per-step ``fq(dequantize(
    embed.wq, f32).T)`` hoisted. Every image goes through
    :func:`fake_quant_dynamic` (K5 on the card).
    """
    _require_dense(cfg)
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
                    out[l] = fake_quant_dynamic(w[l], wb, SIGNED_SYM)
                images[key] = out
            else:
                images[key] = fake_quant_dynamic(w, bits, SIGNED_SYM).to(cd)
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
        if "w" in emb:
            ov["embed"] = {"wfq": image("embed", emb["w"], int(eb[1]))}
        if head_src is not None:
            ov["lm_head"] = {"wfq": image(*head_src, int(hb[1])).t()}
        elif "w" in params["lm_head"]:
            ov["lm_head"] = {"wfq": image("lm_head", params["lm_head"]["w"],
                                          int(hb[1]))}
        lov: dict = {}
        if "w" in lp["qkv"]:
            lov["qkv"] = site("qkv", lp["qkv"]["w"])
            lov["attn_out"] = site("attn_out", lp["attn_out"]["w"])
        if "w" in lp["mlp"]["w_in"]:
            lov["mlp"] = {"w_in": site("mlp_in", lp["mlp"]["w_in"]["w"]),
                          "w_out": site("mlp_out", lp["mlp"]["w_out"]["w"])}
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
                   fault_step: Optional[torch.Tensor] = None):
    """Greedy decode segment of ``len(schedule)`` steps from a mid-generation
    state — the continuous-batching quantum.

    ``tok0 [B]`` is each row's last token (0 for idle rows), ``pos0 [B]``
    its next position, ``remaining [B]`` the tokens it still has to emit
    (0 = retired/free). Rows whose budget runs out freeze: their outputs
    are −1, they feed 0 and keep their position. ``schedule`` holds the
    per-step profile ids (host ints).

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
    steps.

    Returns ``(tokens [B, steps], row_ok [B], tok [B], pos [B], caches)``.
    """
    if paged_backend not in ("kernel", "gather"):
        raise ValueError(f"paged_backend must be kernel|gather, got "
                         f"{paged_backend!r}")
    if prequant is None:
        prequant = prequant_decode_weights(params, cfg, table)
    table = np.asarray(table)
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
        logits, caches = decode_step(overlay_params(params, prequant[pid]),
                                     cfg, table[pid], tok[:, None], pos,
                                     caches, paged_backend=paged_backend)
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


def decode_many(params: dict, cfg: ModelConfig, table, schedule,
                logits0: torch.Tensor, pos0: torch.Tensor, caches: dict,
                row_budget=None, prequant: Optional[list] = None,
                paged_backend: str = "gather"):
    """Greedy decode of ``len(schedule)`` tokens from prefill logits (port
    of the reference's fused ``decode_many``): ``tokens[:, 0]`` is the
    argmax of ``logits0 [B, V]`` (produced under profile ``schedule[0]``),
    then :func:`decode_segment` runs ``schedule[1:]`` from ``pos0 [B]``
    with ``row_budget − 1`` tokens left per row. ``row_budget [B]``
    (default: every step) freezes a row at its budget: its later tokens
    are −1. Returns ``(tokens [B, steps] int32, pids [steps], caches)``;
    ``pids`` is the schedule, the realized per-step profile trace."""
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
        caches, budget - 1, prequant=prequant, paged_backend=paged_backend)
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
    _require_dense(cfg)
    eb, _, layer_bits = split_bits(cfg, bits_row)
    x = embed_lookup(params["embed"], tokens, eb)
    b, w = tokens.shape
    positions = (pos[:, None] + torch.arange(w, dtype=torch.int32,
                                             device=pos.device)[None])
    kv, view = caches["kv"], caches.get("kv_view")
    klads, vlads = [], []
    for l in range(cfg.n_layers):
        lp, lb = _layer(params["layers"], l), layer_bits[l]
        xin = rms_norm(lp["norm_attn"], x)
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
    x = rms_norm(params["norm_f"], x)
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
        live = (rem > 0) & (qta > 0)
        if draft_fn is not None:
            prop = draft_fn(hist, tok).to(torch.int32)
        else:
            prop = ngram_propose(hist, tok, draft_k, cfg.vocab)
        if dov is not None:
            prop = torch.where(dov[i] >= 0, dov[i], prop)
        feed = torch.cat([tok[:, None], prop], dim=1)          # [B, W]
        feed = torch.where(live[:, None], feed, 0)
        logits, caches, (klads, vlads) = decode_step_spec(
            overlay_params(params, prequant[pid]), cfg, table[pid], feed,
            pos, caches, paged_backend=paged_backend)
        # a fault poisons the whole verify window after the KV writes
        logits = torch.where((fs == i)[:, None, None],
                             torch.full((), float("nan"), device=dev),
                             logits)
        ok = ok & (torch.isfinite(logits).all(dim=2).all(dim=1) | ~live)
        g = logits.argmax(dim=-1).to(torch.int32)               # [B, W]
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
