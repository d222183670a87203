"""Logical sharding rules: parameter/activation specs per mesh (port of
``repro/launch/sharding.py``).

The reference's rule table, keyed on parameter path, with its
divisibility fallback (an axis that does not divide is dropped rather than
erroring — e.g. ``global_batch=1`` in ``long_500k`` simply does not shard
over ``data``). Baseline layout:

* **FSDP**: the contraction (d_model) dim of every big matrix shards over
  the data axes (pod+data);
* **TP**: the output dim (heads / d_ff / vocab / experts) shards over
  ``model`` (Megatron column→row pairs);
* **EP**: the expert dim of stacked MoE weights shards over ``model``;
* SSM packed projections stay replicated over ``model``.

A spec is a tuple with one entry per leading dimension of the leaf — an
axis name, a tuple of names (sharded over their product, major first) or
``None`` — with trailing ``None``\\ s stripped, as ``P(*entries)`` keeps
them. Paths are built over the port's trees (nested dicts, ``QTensor``
leaves as ``.../0`` and ``.../1``, the caches' and ``AdamState``'s fields
by name) so that every path string equals the reference's ``_path_str``.
:func:`placements` (kept in ``models/pshard.py``, which the model's
``constrain`` sites share) turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`local_shape` gives one device's shard.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import torch

from repro_torch.core.quantizers import QTensor
from repro_torch.models.pshard import axis_size, mesh_axes, placements

from .mesh import dp_axes

__all__ = ["param_specs", "batch_specs", "cache_specs", "spec_tree",
           "placements", "local_shape", "local_bytes", "tree_map_with_path",
           "flatten_with_path"]


def _fits(dim: int | None, mesh, axes) -> bool:
    if dim is None:
        return False
    n = axis_size(mesh, axes)
    return dim % n == 0 and dim >= n


def _spec(mesh, shape: tuple[int, ...], assign: dict[int, Any]) -> tuple:
    """A spec for ``shape``, dropping axes that do not divide."""
    entries = []
    for i, dim in enumerate(shape):
        ax = assign.get(i)
        entries.append(ax if ax is not None and _fits(dim, mesh, ax)
                       else None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ---------------------------------------------------------------------------
# paths over the port's trees
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable[[str, torch.Tensor], Any], tree,
                       path: str = ""):
    """``tree`` with each tensor leaf replaced by ``fn(path, leaf)``: dicts
    by key, ``QTensor`` by ``0`` (data) and ``1`` (scale), dataclasses and
    named tuples by field name; host fields (``bits``, ``n_blocks``) are
    kept as they are."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(fn(sub(0), tree.data), fn(sub(1), tree.scale),
                       tree.bits, tree.orig_last)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), sub(f))
                            for f in tree._fields))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), sub(f.name))
            for f in dataclasses.fields(tree)})
    return tree


def flatten_with_path(tree, path: str = "") -> list:
    """``[(path, leaf)]`` in the reference's flattening order (dict keys
    sorted, fields in declaration order). A leaf is a tensor or, in a spec
    tree, a spec tuple."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], sub(k))]
    if isinstance(tree, QTensor):
        return [(sub(0), tree.data), (sub(1), tree.scale)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in flatten_with_path(getattr(tree, f), sub(f))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in flatten_with_path(getattr(tree, f.name), sub(f.name))]
    if isinstance(tree, (torch.Tensor, tuple)):
        return [(path, tree)]
    return []


# ---------------------------------------------------------------------------
# the rule table: (regex on path, fn(shape, fsdp, mesh) -> {dim: axis})
# ---------------------------------------------------------------------------

def _param_assign(path: str, shape: tuple[int, ...], fsdp, mesh) -> dict:
    nd = len(shape)
    # native QTensor leaves: <site>/wq/0 = int carrier (same layout as w,
    # packed int4 halves the last dim — divisibility still holds), /1 = scale
    # [.., 1, out] (inherits the weight's last-dim placement)
    m = re.match(r"^(.*?)/wq/\d+$", path)
    if m:
        base = m.group(1)
        assign = _param_assign(base, shape, fsdp, mesh)
        return assign or _param_assign(base + "/w", shape, fsdp, mesh)
    # MoE raw stacked QTensors: layers/moe/w_in/<leaf-idx>
    m = re.match(r"^(.*moe/(?:w_in|w_out))/\d+$", path)
    if m:
        return _param_assign(m.group(1), shape, fsdp, mesh)
    # embeddings: [V, d]
    if re.search(r"(^|/)embed/w$", path):
        return {0: "model", 1: fsdp}
    if re.search(r"(^|/)lm_head/w$", path):
        return {0: fsdp, 1: "model"}
    # MoE stacked experts: [L, E, d, f] — expert parallel + FSDP on d
    if re.search(r"moe/w_in$", path):
        return {1: "model", 2: fsdp}
    if re.search(r"moe/w_out$", path):
        return {1: "model", 3: fsdp}
    if re.search(r"moe/router/w$", path):
        return {1: fsdp}
    # SSM packed projections: replicated over model (see module docstring);
    # FSDP still shards the contraction dim.
    if re.search(r"ssm/(in_proj|out_proj)/w$", path):
        return {nd - 2: fsdp}
    # generic column-parallel producers: [*, d_in, d_out_big]
    if re.search(r"(qkv|w_in|shared_in|mlp/w_in)/?w?$", path) and nd >= 2:
        return {nd - 2: fsdp, nd - 1: "model"}
    # row-parallel consumers: [*, d_big, d_model]
    if re.search(r"(attn_out|w_out|shared_out|mlp/w_out)/?w?$", path) and nd >= 2:
        return {nd - 2: "model", nd - 1: fsdp}
    # biases of column-parallel layers
    if re.search(r"(qkv|w_in|shared_in)/b$", path):
        return {nd - 1: "model"}
    return {}  # norms, scalars, conv, A_log, ... replicated


def _dp_entry(mesh):
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def param_specs(params_like: Any, mesh, *, serve: bool = False):
    """A spec tree for a parameter tree (tensors on any device, ``meta``
    included). ``serve=True`` drops the FSDP dimension (pure TP layout:
    serving holds no optimizer state)."""
    fsdp = None if serve else _dp_entry(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        return _spec(mesh, shape, _param_assign(path, shape, fsdp, mesh))

    return tree_map_with_path(one, params_like)


def batch_specs(batch_like: Any, mesh):
    """Inputs: batch dim over (pod, data); everything else replicated."""
    dp = _dp_entry(mesh)
    return tree_map_with_path(
        lambda path, leaf: _spec(mesh, tuple(leaf.shape), {0: dp}),
        batch_like)


def cache_specs(cache_like: Any, mesh):
    """Decode caches (stacked [L, B, ...]): batch over dp, heads/state over
    model."""
    dp = _dp_entry(mesh)

    def one(p, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        assign: dict[int, Any] = {}
        if nd >= 2:
            assign[1] = dp                      # batch dim
        if re.search(r"kv/(k|v)$", p) and nd == 5:
            if _fits(shape[3], mesh, "model"):
                assign[3] = "model"             # Hkv heads (no psum needed)
            else:
                assign[2] = "model"             # else shard cache slots
        elif re.search(r"kv/token_idx$", p) and nd == 3:
            assign[2] = "model"                 # matches slot-sharded caches
        elif re.search(r"ssm/h$", p) and nd == 5:
            assign[4] = "model"                 # d_state
        elif re.search(r"(k_scale|v_scale)$", p) and nd == 3:
            assign[2] = "model"
        return _spec(mesh, shape, assign)

    return tree_map_with_path(one, cache_like)


def spec_tree(kind: str, like: Any, mesh):
    fn = {"params": param_specs, "batch": batch_specs,
          "cache": cache_specs}[kind]
    return fn(like, mesh)


# ---------------------------------------------------------------------------
# specs on devices
# ---------------------------------------------------------------------------

def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """One device's shard of a ``shape`` tensor laid out by ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        n = axis_size(mesh, entry)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {entry} ({n})")
        out[d] //= n
    return tuple(out)


def local_bytes(leaf: torch.Tensor, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec``."""
    n = 1
    for v in local_shape(tuple(leaf.shape), spec, mesh):
        n *= v
    return n * leaf.element_size()
