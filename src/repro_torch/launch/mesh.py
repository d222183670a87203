"""Mesh descriptions (port of ``repro/launch/mesh.py``).

A :class:`Mesh` is a plain description, an ordered map from axis name to
size, with no device state: the sharding rules and the dry run read only
its shape, so the production meshes are laid over abstract (``meta``)
tensors without a device. Axes:

* single pod: ``(data=16, model=16)`` — 256 devices;
* multi-pod:  ``(pod=2, data=16, model=16)`` — 512 devices; ``pod`` is
  data-parallel (gradient compression in ``optim/compression.py`` targets
  that hop) or the pipeline's stage axis (``distrib/pipeline.py``).

:func:`device_mesh` turns a description into a
``torch.distributed.device_mesh.DeviceMesh`` over the process group that
is up, for DTensor placements (``launch/sharding.py::placements``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["Mesh", "make_production_mesh", "make_tiny_mesh", "dp_axes",
           "dp_size", "device_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in order (``shape`` maps name → size)."""

    shape: Mapping[str, int]

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_tiny_mesh(n_data: int = 2, n_model: int = 2, *,
                   multi_pod: bool = False) -> Mesh:
    """Scaled-down mesh for in-repo distribution tests (8 ranks or fewer)."""
    if multi_pod:
        return Mesh({"pod": 2, "data": n_data, "model": n_model})
    return Mesh({"data": n_data, "model": n_model})


def dp_axes(mesh) -> tuple[str, ...]:
    """Mesh axes used for data parallelism (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over the ranks of
    the default process group, which must have exactly ``mesh.size``
    ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group is initialized")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"device_mesh: the mesh {dict(mesh.shape)} has "
                         f"{mesh.size} devices, the process group {world} "
                         f"ranks")
    return init_device_mesh(device_type, tuple(mesh.shape.values()),
                            mesh_dim_names=mesh.axis_names)
