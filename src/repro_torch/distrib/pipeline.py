"""Pipeline parallelism over a process group (port of
``repro/distrib/pipeline.py``).

The paper's FPGA engine is a spatial pipeline: one hardware block per
layer, activations streaming block to block. Across devices the same shape
is pipeline parallelism: each rank owns a contiguous stage of layers and
microbatches stream stage to stage.

GPipe schedule, one stage per rank of the group:

    t = 0 .. (M + S − 2):   stage s runs microbatch t − s when it exists;
    its output hops s → s+1 at the start of tick t + 1.

Each tick a rank posts its send to s + 1 and its receive from s − 1
together (``batch_isend_irecv``, through host memory on gloo:
:mod:`repro_torch.distrib.collectives`) and waits for both, so the pairs
of every tick match and no rank waits on another's order. A microbatch
that does not exist is neither computed nor sent. The bubble is the usual
(S − 1)/(M + S − 1) of the ticks. The last stage holds every output and
broadcasts them, so each rank returns ``y [B, ...]`` as the reference's
masked ``psum`` gives it. Forward only, as in the reference.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .collectives import broadcast_, exchange

__all__ = ["pipeline_forward", "stage_split"]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_split(params_stacked, n_stages: int) -> list:
    """Layer-stacked params ``[L, ...]`` → a list of ``n_stages`` trees,
    stage ``s`` holding layers ``[s·L/S, (s+1)·L/S)`` (views). Raises
    ``ValueError`` when the layers do not split evenly (the reference
    asserts)."""
    def check(a):
        if a.shape[0] % n_stages:
            raise ValueError(f"{a.shape[0]} layers don't split into "
                             f"{n_stages} stages")
        return a
    _map(check, params_stacked)

    def stage(s):
        def one(a):
            n = a.shape[0] // n_stages
            return a[s * n:(s + 1) * n]
        return _map(one, params_stacked)
    return [stage(s) for s in range(n_stages)]


def pipeline_forward(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                     n_microbatches: int, group=None) -> torch.Tensor:
    """Run ``x [B, ...]`` through the group's stages, microbatched.

    ``stage_fn(stage_params, xm) -> xm`` applies this rank's stage to one
    microbatch (its output has its input's shape and dtype);
    ``stage_params`` are this rank's own (``stage_split(...)[rank]``).
    Every rank passes the same ``x`` (stage 0 reads it). Returns the last
    stage's output for every microbatch, ``[B, ...]``, on every rank."""
    s = dist.get_rank(group)
    n_stages = dist.get_world_size(group)
    ranks = dist.get_process_group_ranks(group) if group is not None \
        else list(range(n_stages))
    m = n_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    xm = x.reshape(m, b // m, *x.shape[1:])
    outs = torch.empty_like(xm)
    prev = ranks[s - 1] if s > 0 else None
    nxt = ranks[s + 1] if s < n_stages - 1 else None
    y = None
    for t in range(m + n_stages - 1):
        i = t - s                          # the microbatch this tick runs
        send = y if nxt is not None and 0 <= t - 1 - s < m else None
        recv = torch.empty_like(xm[0]) if prev is not None and 0 <= i < m \
            else None
        exchange(send, nxt, recv, prev, group)
        y = None
        if 0 <= i < m:
            y = stage_fn(stage_params, xm[i] if s == 0 else recv)
            if s == n_stages - 1:
                outs[i] = y
    broadcast_(outs, ranks[-1], group)
    return outs.reshape(b, *x.shape[1:])
