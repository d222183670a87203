"""AdamW with warmup-cosine schedule and global-norm clipping (port of
``repro/optim/adam.py``), on nested dicts of tensors.

The reference's own update, not ``torch.optim.AdamW`` (whose decoupled
decay and ``eps`` placement give other numbers): clip the gradients to
``clip_norm`` first, then bias-correct the moments and step by
``lr · (mh / (sqrt(vh) + eps) + weight_decay · p)``. Every scalar (step,
learning rate, corrections, norm) stays a device tensor in f32, as in the
reference, so a step never waits on the host. Leaves are visited in the
reference's order (dict keys sorted), so the global norm sums alike.

:func:`adam_update_` is the same step in place, for a tree of several GB
(a 2.5 B-parameter model's f32 masters and moments): it clips the
gradients and writes the parameters and moments into the tensors it is
given, leaf by leaf and, on a large leaf, a run of rows of its leading
axis at a time, with the same arithmetic in the same order, so its values are
bitwise :func:`adam_update`'s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update",
           "adam_update_",
           "warmup_cosine", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    mu: dict
    nu: dict


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    return [tree]


def adam_init(params) -> AdamState:
    zeros = _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params)
    device = _leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros, nu=_tree_map(torch.clone, zeros))


def warmup_cosine(cfg: AdamConfig, step: torch.Tensor) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(l.float())) for l in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _tree_map(lambda g: g * scale, tree), norm


@torch.no_grad()
def adam_update(cfg: AdamConfig, grads, state: AdamState, params):
    """One AdamW step. Returns ``(new_params, new_state, metrics)``; the
    new parameters are fresh tensors that record no graph."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)

    def upd(p, g, m, v):
        g = g.float()
        m_ = cfg.b1 * m + (1 - cfg.b1) * g
        v_ = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m_ / b1c
        vh = v_ / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_, v_

    out = _tree_map(upd, params, grads, state.mu, state.nu)
    new_p, new_m, new_v = (_tree_map(lambda _, o: o[i], params, out)
                           for i in range(3))
    return new_p, AdamState(step, new_m, new_v), \
        {"grad_norm": gnorm, "lr": lr}


_SLICE = 1 << 24          # elements above which a leaf goes slice by slice


def _slices(*ts):
    """Matching views of same-shaped tensors: runs of the leading axis of
    at most ``_SLICE`` elements each (at least one row) for a large leaf,
    else the whole tensors. The in-place AdamW and the gradient
    compressor (:mod:`repro_torch.optim.compression`) both go by them, so
    a multi-GB leaf never has more than one run of temporaries beside
    it."""
    t = ts[0]
    if t.dim() >= 1 and t.numel() > _SLICE and t.shape[0] > 1:
        rows = max(1, _SLICE // (t.numel() // t.shape[0]))
        return list(zip(*(x.split(rows) for x in ts)))
    return [ts]


@torch.no_grad()
def adam_update_(cfg: AdamConfig, grads, state: AdamState, params):
    """:func:`adam_update` in place: the gradients are clipped in place,
    and the new parameters and moments are written into ``params``,
    ``state.mu`` and ``state.nu`` (which must be f32, as ``adam_init``
    makes them). Returns ``(params, new_state, metrics)``; ``new_state``
    holds the same moment tensors and a new step."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = warmup_cosine(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    for p_, g_, m_, v_ in zip(_leaves(params), _leaves(grads),
                              _leaves(state.mu), _leaves(state.nu)):
        g_.mul_(scale)
        for p, g, m, v in _slices(p_, g_, m_, v_):
            g = g.float()
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            t = g * (1 - cfg.b2)
            v.mul_(cfg.b2).add_(t.mul_(g))
            delta = m / b1c
            t = torch.div(v, b2c, out=t).sqrt_().add_(cfg.eps)
            delta.div_(t)
            delta.add_(torch.mul(p.float(), cfg.weight_decay, out=t))
            del t
            if p.dtype == torch.float32:
                p.sub_(delta.mul_(lr))
            else:
                p.copy_((p.float() - delta.mul_(lr)).to(p.dtype))
    return params, AdamState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
