"""Abstract input and parameter specs for the dry run (port of
``repro/launch/specs.py``): everything lives on the ``meta`` device.

Parameter trees are the real initializers run on ``meta`` (and
``to_native`` for native weights), batches are meta tensors of the exact
shapes and dtypes of the data pipeline, and the step functions are the
same functions the port's launchers run: the training launcher's in-place
step (:mod:`repro_torch.launch.train`) and the model's ``forward`` /
``decode_step``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.common import Shape
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.profiles import paper_profiles
from repro_torch.models import transformer as T
from repro_torch.models.native import to_native
from repro_torch.optim.adam import AdamConfig, adam_init

__all__ = ["build_engine", "adapt_config", "input_specs", "abstract_params",
           "abstract_opt", "abstract_caches", "make_train_step_fn",
           "make_prefill_fn", "make_decode_fn", "KV_SLOTS", "META"]

KV_SLOTS = {"decode_32k": 32_768, "long_500k": 524_288, "prefill_32k": 32_768}
META = torch.device("meta")


def adapt_config(cfg: T.ModelConfig, shape: Shape, dp: int) -> T.ModelConfig:
    """Shape-dependent static knobs: align MoE dispatch groups with the DP
    degree, bound the loss chunk by the sequence."""
    upd: dict[str, Any] = {}
    if cfg.moe is not None:
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        g = dp if tokens % dp == 0 else math.gcd(cfg.moe.groups, tokens)
        upd["moe"] = dataclasses.replace(cfg.moe, groups=max(1, g))
    if shape.seq_len < cfg.loss_chunk:
        upd["loss_chunk"] = shape.seq_len
    return dataclasses.replace(cfg, **upd) if upd else cfg


def build_engine(cfg: T.ModelConfig) -> AdaptiveEngine:
    """Merged adaptive engine over the paper's profile family for this arch
    (``Mixed`` drops the middle third of the layers to A4-W4), its
    ``apply_fn`` the training loss, as the training launcher builds it."""
    names = T.quant_layer_names(cfg)
    lo, hi = cfg.n_layers // 3, 2 * cfg.n_layers // 3
    inner = [n for n in names
             if n.startswith("L") and lo <= int(n[1:].split(".")[0]) < hi]
    profs = paper_profiles(names, inner_layers=inner)
    return AdaptiveEngine(tuple(profs), QuantIndex(names),
                          lambda p, br, b: T.train_loss(p, cfg, br, b))


def input_specs(cfg: T.ModelConfig, shape: Shape) -> dict:
    """Meta stand-ins for the step inputs of this (arch × shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def t(*dims, dtype=i32):
        return torch.empty(dims, dtype=dtype, device=META)
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio":
            batch = {"features": t(b, s, cfg.feature_dim, dtype=torch.float32),
                     "labels": t(b, s)}
        elif cfg.frontend == "vision":
            batch = {"tokens": t(b, s),
                     "patch_embeds": t(b, cfg.n_patches, cfg.d_model,
                                       dtype=torch.float32),
                     "labels": t(b, s)}
        else:
            batch = {"tokens": t(b, s), "labels": t(b, s)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"tokens": t(b, 1), "pos": t(b)}


def abstract_params(cfg: T.ModelConfig, *, native_bits: int | None = None):
    """The initializer's tree on ``meta`` (``to_native`` applied for
    ``native_bits``): shapes and dtypes, no storage."""
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device=META)
    if native_bits is not None:
        p = to_native(p, native_bits)
    return p


def abstract_opt(params_like):
    return adam_init(params_like)


def abstract_caches(cfg: T.ModelConfig, shape: Shape, *, kv_bits: int = 16):
    slots = KV_SLOTS.get(shape.name, shape.seq_len)
    return T.init_caches(cfg, shape.global_batch, slots, kv_bits=kv_bits,
                         device=META)


# ---------------------------------------------------------------------------
# step functions (shared by the dry run and the launchers)
# ---------------------------------------------------------------------------

def make_train_step_fn(cfg: T.ModelConfig, engine: AdaptiveEngine,
                       adam_cfg: AdamConfig = AdamConfig()) -> Callable:
    """(params, opt, profile_id, batch) → (params, opt, metrics): the
    training launcher's step (the loss and its gradients, then AdamW in
    place)."""
    from repro_torch.launch.train import _step_factory

    def loss_fn(params, batch):
        return engine(params, batch["profile_id"],
                      {k: v for k, v in batch.items() if k != "profile_id"})
    inner = _step_factory({"state": None}, None)(loss_fn, adam_cfg)

    def step(params, opt, profile_id, batch):
        return inner(params, opt, {**batch, "profile_id": int(profile_id)})

    return step


def make_prefill_fn(cfg: T.ModelConfig, engine: AdaptiveEngine) -> Callable:
    """(params, profile_id, batch) → the last position's logits."""

    def step(params, profile_id, batch):
        bits = engine.bits_row(profile_id)
        hidden, _, _ = T.forward(params, cfg, bits, batch)
        return T._logits(cfg, params, bits, hidden[:, -1:])[:, 0]

    return step


def make_decode_fn(cfg: T.ModelConfig, engine: AdaptiveEngine) -> Callable:
    """(params, profile_id, tokens, pos, caches) → (logits, caches)."""

    def step(params, profile_id, tokens, pos, caches):
        bits = engine.bits_row(profile_id)
        return T.decode_step(params, cfg, bits, tokens, pos, caches,
                             paged_backend="kernel")

    return step
