"""Int8 gradient compression with error feedback (port of
``repro/optim/compression.py``), on nested dicts of tensors.

Each leaf is quantized to int8 with stochastic rounding and one f32 scale,
``amax / 127`` with ``amax`` floored at 1e-12; the quantizer is
``round(g/s + U − 0.5)`` clipped to ±127, with ``round`` half to even
(``jnp.round``, ``torch.round``), not the quantizers' half-away rule. The
residual ``corrected − q·s`` is carried to the next step (error feedback),
so the accumulated signal tracks the accumulated gradient. The wire format
is int8 plus one f32 scale per leaf.

The draw is kept apart from the arithmetic: :func:`quantize_leaf` takes
the uniforms ``U``, and :func:`compress_tree` draws them from a
``torch.Generator`` where the reference splits a PRNG key per leaf (or
takes them as given), so a test can feed both packages the same draws.
Leaves are visited in the reference's order (dict keys sorted).

``compress_tree`` updates the residual in place, one leaf at a time and, on
a large leaf, a run of rows of its leading axis at a time (the arithmetic is
elementwise, so the slices change no value), so a leaf of several GB
never has more than one slice of temporaries beside it; with
``release=True`` it also drops each raw gradient from ``grads`` as soon as
that leaf is compressed. :func:`compressed_psum` is the reduction over a
process group: compress locally, all-reduce ``q · s`` per leaf in f32 (the
reference's wire: it sums f32 payloads), divide by the group's size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.optim.adam import _slices

__all__ = ["CompressionState", "init_error_feedback", "quantize_leaf",
           "compress_tree", "decompress_tree", "compressed_psum"]


class CompressionState(NamedTuple):
    residual: dict  # error-feedback memory, same structure as grads


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_error_feedback(params) -> CompressionState:
    """A zero f32 residual for each leaf of ``params``."""
    res: dict = {}
    for path in _paths(params):
        _set(res, path, torch.zeros_like(_get(params, path),
                                         dtype=torch.float32))
    return CompressionState(residual=res)


def quantize_leaf(corrected: torch.Tensor, u: torch.Tensor,
                  scale: Optional[torch.Tensor] = None):
    """``(q int8, scale)`` of one leaf given its uniforms ``u`` (f32, the
    leaf's shape, in ``[0, 1)``): ``scale = max(amax, 1e-12) / 127``
    unless given (a slice of a leaf takes the whole leaf's), ``q =
    clip(round(corrected/scale + u − 0.5), −127, 127)``."""
    if scale is None:
        scale = corrected.abs().amax().clamp_min(1e-12) / 127.0
    noise = u - 0.5
    t = corrected / scale
    t.add_(noise)
    del noise
    q = t.round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def compress_tree(grads, state: CompressionState,
                  generator: Optional[torch.Generator] = None,
                  uniforms=None, release: bool = False):
    """→ ``(int8 tree, scales tree, state)``: the residual is added before
    quantizing and the quantization error becomes the next residual
    (error feedback), written into ``state.residual`` in place. The
    uniforms of each leaf are ``uniforms``' leaf when given, else drawn
    from ``generator`` (on the gradients' device). ``release`` removes
    each leaf from ``grads`` once it is compressed."""
    if uniforms is None and generator is None:
        raise ValueError("compress_tree needs a generator or uniforms")
    qs: dict = {}
    scales: dict = {}
    for path in list(_paths(grads)):
        g = _get(grads, path)
        r = _get(state.residual, path)
        r.add_(g)                                # corrected = g + r
        if release:
            _set(grads, path, None)
        del g
        scale = r.abs().amax().clamp_min(1e-12) / 127.0
        u_leaf = None if uniforms is None else _get(uniforms, path)
        q = torch.empty(r.shape, dtype=torch.int8, device=r.device)
        us = () if u_leaf is None else (u_leaf,)
        for rp, qp, *up in _slices(r, q, *us):
            u = up[0] if up else torch.rand(
                rp.shape, generator=generator, dtype=torch.float32,
                device=rp.device)
            qi, _ = quantize_leaf(rp, u, scale)
            del u
            qp.copy_(qi)
            rp.sub_(qi.float().mul_(scale))      # corrected − q·s
        _set(qs, path, q)
        _set(scales, path, scale)
    return qs, scales, state


def decompress_tree(q_tree, scales, release: bool = False):
    """``q · s`` in f32 per leaf; ``release`` removes each int8 leaf from
    ``q_tree`` once it is read."""
    out: dict = {}
    for path in list(_paths(q_tree)):
        q = _get(q_tree, path)
        if release:
            _set(q_tree, path, None)
        _set(out, path, q.float().mul_(_get(scales, path)))
    return out


def compressed_psum(grads, state: CompressionState, u_or_generator,
                    group=None):
    """The mean over ``group``'s ranks of each rank's compressed gradients,
    as the reference's ``compressed_psum`` computes it inside
    ``shard_map``: quantize locally (:func:`compress_tree`, with the
    uniforms tree or ``torch.Generator`` given), all-reduce ``q.float() ·
    s`` per leaf, divide by the group size. Returns ``(mean tree,
    state)``; the new residual is the local one, as in the reference."""
    import torch.distributed as dist
    from repro_torch.distrib.collectives import all_reduce_
    if isinstance(u_or_generator, torch.Generator):
        q, s, state = compress_tree(grads, state, generator=u_or_generator)
    else:
        q, s, state = compress_tree(grads, state, uniforms=u_or_generator)
    n = dist.get_world_size(group)
    out: dict = {}
    for path in _paths(q):
        payload = _get(q, path).float() * _get(s, path)
        _set(out, path, all_reduce_(payload, group) / n)
    return out, state
