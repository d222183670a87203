"""Logical activation-sharding constraints (port of
``repro/models/pshard.py``).

Model code stays mesh-agnostic: it names logical axes only ("dp" for the
batch, "tp" for heads or features). The launcher calls :func:`enable` with
the mesh (dp = pod+data axes). :func:`constrain` then pins the hot
intermediates of a DTensor computation with the reference's decision per
dimension: the axis if ``dim % axis_size == 0 and dim > 1``, else none
(e.g. 50 hymba heads on 16-way TP, where the call site shards another
dimension).

``constrain`` is a no-op, dispatching no op, when disabled (tests,
single-device runs) or when ``x`` is a plain tensor: an eager tensor has
no layout to pin. On a ``DTensor`` it redistributes to the placements the
decision names over the DTensor's own mesh (matched by axis name).

The spec helpers the launcher's sharding rules share with it live here
(:func:`mesh_axes`, :func:`axis_size`, :func:`placements`), so the
dependency runs from ``launch`` to ``models`` only.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["enable", "disable", "constrain", "enabled", "decide",
           "mesh_axes", "axis_size", "placements"]

_STATE: dict = {"mesh": None, "dp": None, "tp": None}


def enable(mesh, dp_axes, tp_axis: str = "model") -> None:
    """``mesh``: a description with ``shape`` (name → size), e.g.
    :class:`repro_torch.launch.mesh.Mesh`; ``dp_axes``: an axis name or a
    tuple of them."""
    _STATE.update(mesh=mesh, dp=dp_axes, tp=tp_axis)


def disable() -> None:
    _STATE.update(mesh=None, dp=None, tp=None)


def enabled() -> bool:
    return _STATE["mesh"] is not None


def mesh_axes(entry) -> tuple:
    """The axis names of a spec entry (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axis_size(mesh, entry) -> int:
    """Devices a spec entry spans on ``mesh`` (1 for ``None``)."""
    n = 1
    for a in mesh_axes(entry):
        n *= mesh.shape[a]
    return n


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` (entries for leading dims), one per
    axis of ``mesh`` — a description or a ``DeviceMesh`` — in its order:
    ``Shard(d)`` where axis ``a`` appears in entry ``d``, else
    ``Replicate()``. A dimension over two axes shards over both, the
    earlier mesh axis major, as the reference's tuple entries do."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: d for d, entry in enumerate(spec) for a in mesh_axes(entry)}
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def decide(shape, logical) -> tuple:
    """The reference's spec entries for a ``shape`` tensor under the
    logical names (one per dim; "dp" | "tp" | None), with the mesh
    :func:`enable` set: an axis (or tuple of axes) or ``None`` per dim."""
    mesh = _STATE["mesh"]
    if len(logical) != len(shape):
        raise ValueError(f"constrain: {len(logical)} logical names for a "
                         f"{len(shape)}-d tensor {tuple(shape)}")
    entries = []
    for dim, name in zip(shape, logical):
        ax = _STATE.get(name) if name else None
        if ax is not None and dim % axis_size(mesh, ax) == 0 and dim > 1:
            entries.append(ax)
        else:
            entries.append(None)
    return tuple(entries)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``logical`` entries: "dp" | "tp" | None, one per dim of ``x``."""
    if _STATE["mesh"] is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    entries = decide(x.shape, logical)
    if all(e is None for e in entries):
        return x
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh, entries))
