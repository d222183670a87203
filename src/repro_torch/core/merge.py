"""MDC-analogue profile merging: which layers are shared, what is the overhead.

Copy of ``repro/core/merge.py`` (numpy-only), imports rewritten for the port.

The Multi-Dataflow Composer of the paper merges the dataflow graphs of several
execution profiles into one reconfigurable datapath, *sharing the actors whose
configuration is identical across profiles*. On TPU the "actor" is a layer's
quantized execution; merging manifests as:

* **shared layer** — identical ``(a_bits, w_bits)`` in all profiles → one code
  path, one (quantized) weight image;
* **switched layer** — differing specs → the merged engine holds one quantized
  weight image *per distinct spec* (not per profile!) and a runtime selection.

:func:`merge_plan` computes that structure plus the resource-accounting used to
reproduce the paper's Fig. 4 overhead numbers (merged engine vs the sum of the
standalone engines).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .profiles import Profile
from .qtypes import QuantSpec, nbytes_of

__all__ = ["MergePlan", "merge_plan"]


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """Static merge structure for a set of profiles over one model."""

    profiles: tuple[str, ...]
    layer_names: tuple[str, ...]
    # per layer: tuple of distinct (a_bits, w_bits) specs, stable order
    distinct_specs: Mapping[str, tuple[tuple[int, int], ...]]
    # per layer, per profile: index into distinct_specs[layer]
    selector: Mapping[str, tuple[int, ...]]

    @property
    def shared_layers(self) -> tuple[str, ...]:
        return tuple(ln for ln in self.layer_names if len(self.distinct_specs[ln]) == 1)

    @property
    def switched_layers(self) -> tuple[str, ...]:
        return tuple(ln for ln in self.layer_names if len(self.distinct_specs[ln]) > 1)

    def sharing_ratio(self) -> float:
        return len(self.shared_layers) / max(1, len(self.layer_names))

    def resource_bytes(self, weight_shapes: Mapping[str, tuple[int, ...]]) -> dict:
        """Paper-Fig.4 style accounting (weight-image bytes as the BRAM analogue).

        Returns merged bytes, per-profile standalone bytes, and the overhead of
        the merged engine vs the *largest* standalone engine (the paper compares
        the adaptive engine to the most accurate non-adaptive profile).
        """
        merged = 0
        standalone = {p: 0 for p in self.profiles}
        for ln in self.layer_names:
            shape = weight_shapes[ln]
            for (ab, wb) in self.distinct_specs[ln]:
                merged += nbytes_of(shape, QuantSpec(bits=None if wb >= 17 else wb))
            for pi, p in enumerate(self.profiles):
                ab, wb = self.distinct_specs[ln][self.selector[ln][pi]]
                standalone[p] += nbytes_of(shape, QuantSpec(bits=None if wb >= 17 else wb))
        biggest = max(standalone.values())
        return {
            "merged_bytes": merged,
            "standalone_bytes": standalone,
            "sum_standalone_bytes": sum(standalone.values()),
            "overhead_vs_largest": merged / biggest - 1.0 if biggest else 0.0,
            "saving_vs_sum": 1.0 - merged / max(1, sum(standalone.values())),
        }


def merge_plan(profiles: Sequence[Profile]) -> MergePlan:
    """Compute the merged multi-profile structure (the MDC front-end analogue)."""
    if not profiles:
        raise ValueError("need at least one profile")
    layer_names = profiles[0].layer_names
    for p in profiles[1:]:
        if p.layer_names != layer_names:
            raise ValueError(
                f"profiles disagree on layers: {p.name} vs {profiles[0].name}")
    distinct: dict[str, tuple[tuple[int, int], ...]] = {}
    selector: dict[str, tuple[int, ...]] = {}
    for ln in layer_names:
        specs: list[tuple[int, int]] = []
        sel: list[int] = []
        for p in profiles:
            s = tuple(p.bits[ln])
            if s not in specs:
                specs.append(s)
            sel.append(specs.index(s))
        distinct[ln] = tuple(specs)
        selector[ln] = tuple(sel)
    return MergePlan(
        profiles=tuple(p.name for p in profiles),
        layer_names=layer_names,
        distinct_specs=distinct,
        selector=selector,
    )
