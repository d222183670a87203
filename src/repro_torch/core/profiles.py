"""Execution profiles — the paper's ``Ax-Wy`` data-approximation configurations.

Port of ``repro/core/profiles.py``: the bits table is a numpy array (host
data in the port).

A :class:`Profile` assigns every quantizable layer of a model a pair
``(a_bits, w_bits)`` — activation and weight precision — exactly like the
paper's profile strings (``A16-W8`` … ``A4-W4``) plus intra-network mixed
profiles (their ``Mixed`` = A8-W8 with the inner conv at A4-W4).

Profiles compile to a dense ``[n_profiles, n_layers, 2]`` int32 table
(:func:`profile_table`); at runtime the active profile is *data* (an index into
the table), which is what lets the merged engine switch profiles without
recompilation (DESIGN §8.1).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Sequence

import numpy as np

__all__ = ["Profile", "profile_table", "parse_profile_string", "paper_profiles",
           "PAPER_PROFILES", "FLOAT_BITS"]

# bits >= 17 means "float passthrough" in the spec-as-data encoding.
FLOAT_BITS = 32

_NAME_RE = re.compile(r"^A(\d+)-W(\d+)$")


@dataclasses.dataclass(frozen=True, eq=False)
class Profile:
    """Per-layer precision assignment for one execution profile."""

    name: str
    bits: Mapping[str, tuple[int, int]]  # layer name -> (a_bits, w_bits)

    def __hash__(self):  # stable content hash (bits is a dict)
        return hash((self.name, tuple(sorted(self.bits.items()))))

    def __eq__(self, other):
        return isinstance(other, Profile) and self.name == other.name and \
            dict(self.bits) == dict(other.bits)

    @staticmethod
    def uniform(name: str, layer_names: Sequence[str],
                a_bits: int | None = None, w_bits: int | None = None) -> "Profile":
        """Build e.g. ``A8-W4`` over all layers; bits parsed from ``name`` if omitted."""
        if a_bits is None or w_bits is None:
            a_bits, w_bits = parse_profile_string(name)
        return Profile(name, {ln: (a_bits, w_bits) for ln in layer_names})

    @staticmethod
    def float32(layer_names: Sequence[str]) -> "Profile":
        return Profile("float", {ln: (FLOAT_BITS, FLOAT_BITS) for ln in layer_names})

    def override(self, name: str, overrides: Mapping[str, tuple[int, int]]) -> "Profile":
        """Derive a mixed profile (paper §4.3): replace precision on some layers."""
        merged = dict(self.bits)
        for k, v in overrides.items():
            if k not in merged:
                raise KeyError(f"unknown layer {k!r}; known: {sorted(merged)}")
            merged[k] = v
        return Profile(name, merged)

    @property
    def layer_names(self) -> tuple[str, ...]:
        return tuple(self.bits)

    def a_bits(self, layer: str) -> int:
        return self.bits[layer][0]

    def w_bits(self, layer: str) -> int:
        return self.bits[layer][1]


def parse_profile_string(s: str) -> tuple[int, int]:
    """``"A8-W4"`` → ``(8, 4)``."""
    m = _NAME_RE.match(s)
    if not m:
        raise ValueError(f"profile string {s!r} does not match 'Ax-Wy'")
    return int(m.group(1)), int(m.group(2))


def profile_table(profiles: Sequence[Profile], layer_names: Sequence[str]) -> np.ndarray:
    """Dense ``[P, L, 2]`` int32 table of (a_bits, w_bits); the merged engine's
    "configuration memory" (the analogue of MDC's datapath configuration)."""
    if not profiles:
        raise ValueError("need at least one profile")
    tab = np.zeros((len(profiles), len(layer_names), 2), np.int32)
    for p, prof in enumerate(profiles):
        missing = [ln for ln in layer_names if ln not in prof.bits]
        if missing:
            raise KeyError(f"profile {prof.name!r} missing layers {missing}")
        for l, ln in enumerate(layer_names):
            tab[p, l] = prof.bits[ln]
    return tab


def paper_profiles(layer_names: Sequence[str], inner_layers: Sequence[str] = ()) -> list[Profile]:
    """The exact profile family evaluated by the paper (§4.2-4.3).

    ``inner_layers`` are the layers dropped to A4-W4 in the ``Mixed`` profile
    (the paper uses the inner convolutional layer).
    """
    profs = [Profile.uniform(n, layer_names)
             for n in ("A16-W8", "A16-W4", "A8-W8", "A8-W4", "A4-W4")]
    base = Profile.uniform("A8-W8", layer_names)
    mixed = base.override("Mixed", {ln: (4, 4) for ln in inner_layers}) if inner_layers else base
    profs.append(dataclasses.replace(mixed, name="Mixed"))
    return profs


PAPER_PROFILES = ("A16-W8", "A16-W4", "A8-W8", "A8-W4", "A4-W4", "Mixed")
