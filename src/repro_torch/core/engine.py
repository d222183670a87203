"""Adaptive inference engine (port of ``repro/core/engine.py``).

All profiles of the family share one model; the active profile is a row of
the ``[P, L, 2]`` bits table (host data in the port), so switching profiles
costs one index — no weight reload, mirroring MDC reconfiguration. Layers
whose precision coincides across profiles share their weight image (the
merge plan's shared layers).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

from .merge import MergePlan, merge_plan
from .profiles import Profile, profile_table

__all__ = ["QuantIndex", "AdaptiveEngine"]


@dataclasses.dataclass(frozen=True)
class QuantIndex:
    """Static layer-name → row-index map shared by a model and its engine."""

    layer_names: tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "_idx", {n: i for i, n in enumerate(self.layer_names)})

    def index(self, name: str) -> int:
        return self._idx[name]

    def a_bits(self, bits_row: np.ndarray, name: str) -> int:
        return int(bits_row[self._idx[name], 0])

    def w_bits(self, bits_row: np.ndarray, name: str) -> int:
        return int(bits_row[self._idx[name], 1])

    def gather(self, bits_row: np.ndarray, names: Sequence[str]) -> np.ndarray:
        """Stack bits for ``names`` → ``[len(names), 2]``."""
        return np.asarray(bits_row)[[self._idx[n] for n in names]]


@dataclasses.dataclass(frozen=True, eq=False)
class AdaptiveEngine:
    """Merged multi-profile executor. ``apply_fn(params, bits_row, *inputs)``
    may be ``None`` where the engine only carries the table (the serving
    path calls the model functions itself)."""

    profiles: tuple[Profile, ...]
    index: QuantIndex
    apply_fn: Optional[Callable[..., Any]] = None

    def __post_init__(self):
        object.__setattr__(self, "table", profile_table(self.profiles, self.index.layer_names))
        object.__setattr__(self, "plan", merge_plan(self.profiles))

    @property
    def profile_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.profiles)

    def profile_id(self, name: str) -> int:
        return self.profile_names.index(name)

    def bits_row(self, profile_id: int) -> np.ndarray:
        return self.table[int(profile_id)]

    def __call__(self, params, profile_id: int, *inputs, **kw):
        if self.apply_fn is None:
            raise TypeError("engine was built without an apply_fn")
        return self.apply_fn(params, self.bits_row(profile_id), *inputs, **kw)

    def merge_report(self, weight_shapes: Mapping[str, tuple[int, ...]] | None = None) -> dict:
        plan: MergePlan = self.plan
        rep = {
            "profiles": list(plan.profiles),
            "n_layers": len(plan.layer_names),
            "shared_layers": list(plan.shared_layers),
            "switched_layers": list(plan.switched_layers),
            "sharing_ratio": plan.sharing_ratio(),
        }
        if weight_shapes is not None:
            rep["resources"] = plan.resource_bytes(weight_shapes)
        return rep
