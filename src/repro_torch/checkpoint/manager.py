"""Atomic, versioned checkpoints with retention and a per-leaf manifest
(port of ``repro/checkpoint/manager.py``, in its on-disk format).

Layout per step::

    <dir>/step_000123/
        arrays.npz        flattened tree leaves ("/"-joined key paths)
        meta.json         step, keys, per-leaf manifest (shape/dtype/crc32),
                          metadata, process_count
    <dir>/step_000123.DONE  (commit marker: written last, after the rename)

Either package restores a directory the other wrote. A restart picks the
newest *committed* step, so a process dying mid-write never corrupts a
restore (the torn directory is ignored and garbage-collected). A leaf that
contradicts its manifest raises :class:`CheckpointIntegrityError`, or with
``strict=False`` is dropped and listed in ``meta["corrupt_keys"]``, so a
caller with a per-leaf fallback (the serving durability layer re-prefills
a corrupted row from its prompt) salvages the rest.

Trees are nested dicts, lists and tuples (``None`` is an empty subtree, as
in a JAX pytree); dict keys are walked in sorted order, as JAX flattens
them, and a NamedTuple's leaves (``AdamState``) are keyed by field name,
as JAX keys them. Leaves are ``torch.Tensor`` (copied to the host) or ``np.ndarray``.
numpy has no bf16: a bf16 tensor is stored as the int16 view of its 16
bits with ``"bfloat16"`` in its manifest entry, and restores bitwise.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.runtime import resolve_device

__all__ = ["save", "restore", "latest_step", "CheckpointManager",
           "CheckpointIntegrityError"]

_DONE = ".DONE"
_BF16 = "bfloat16"


class CheckpointIntegrityError(ValueError):
    """A stored leaf contradicts the checkpoint's own manifest: missing,
    another shape or dtype than ``meta.json`` recorded, or a failed crc32
    (the directory was corrupted after its commit). Distinct from the
    errors a healthy checkpoint raises against a mismatched ``tree_like``
    (``KeyError`` / plain ``ValueError``)."""


def _items(tree, prefix: str = ""):
    """``(key path, leaf)`` pairs in JAX's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}{name}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}/")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, leaves, f"{prefix}{name}/")
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _items(tree):
        flat[key], dtypes[key] = _host(leaf)
    return flat, dtypes


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(directory: str, step: int, tree: Any,
         metadata: Optional[dict] = None) -> str:
    """Atomic checkpoint write; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {k: {"shape": list(v.shape), "dtype": dtypes[k],
                    "crc32": _crc(v)} for k, v in flat.items()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat),
                   "manifest": manifest,
                   "metadata": metadata or {},
                   "process_count": 1}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # commit marker last: restore trusts marked steps only
    with open(final + _DONE, "w") as f:
        f.write(name)
    return final


def _committed_steps(directory: str) -> list[int]:
    """Committed steps, oldest to newest. A marker whose directory has
    vanished (a concurrent ``_gc`` between the listing and the read) does
    not count: collection removes the marker first, so marker and
    directory together mean the payload is complete."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for n in os.listdir(directory):
        if n.startswith("step_") and n.endswith(_DONE):
            if os.path.isdir(os.path.join(directory, n[:-len(_DONE)])):
                steps.append(int(n[len("step_"):-len(_DONE)]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _load_step(path: str) -> tuple[dict, dict]:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return flat, meta


def _is_bf16(arr: np.ndarray, dtype: str) -> bool:
    """A stored 16-bit leaf whose manifest says bf16: the port writes the
    int16 view, the reference's npz holds raw ``V2`` records."""
    return dtype == _BF16 and arr.dtype.itemsize == 2 \
        and arr.dtype.kind in "iV"


def _validate(flat: dict, meta: dict, strict: bool) -> list[str]:
    """Check every leaf against the manifest; returns the corrupt keys.
    ``strict`` raises :class:`CheckpointIntegrityError` at the first
    problem; otherwise the bad keys are collected and removed from
    ``flat``."""
    manifest = meta.get("manifest")
    if manifest is None:             # pre-manifest checkpoint: nothing to check
        return []
    bad: list[str] = []

    def flag(key, why):
        if strict:
            raise CheckpointIntegrityError(f"checkpoint leaf {key!r}: {why}")
        bad.append(key)

    for key, spec in manifest.items():
        if key not in flat:
            flag(key, "missing from arrays.npz")
            continue
        arr = flat[key]
        if list(arr.shape) != list(spec["shape"]):
            flag(key, f"shape {list(arr.shape)} != manifest {spec['shape']}")
        elif str(arr.dtype) != spec["dtype"] \
                and not _is_bf16(arr, spec["dtype"]):
            flag(key, f"dtype {arr.dtype} != manifest {spec['dtype']}")
        elif _crc(arr) != spec["crc32"]:
            flag(key, "crc32 mismatch (bit-rot or truncated write)")
    for key in sorted(set(flat) - set(manifest)):
        flag(key, "not in manifest")
    for key in bad:
        flat.pop(key, None)
    return bad


def _unflatten_keys(flat: dict) -> dict:
    """A nested dict from the "/"-joined key paths (``tree_like=None``:
    durability checkpoints have a data-dependent structure)."""
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a host tensor (bf16 leaves bitwise)."""
    # ascontiguousarray makes a 0-d array 1-d: keep the stored shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if _is_bf16(arr, dtype):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, tree_like: Any = None, step: Optional[int] = None,
            device: Union[str, torch.device, None] = None,
            strict: bool = True) -> tuple[Any, dict]:
    """Restore a committed checkpoint; returns ``(tree, meta)``.

    With ``tree_like`` the payload is matched to that structure (a missing
    leaf raises ``KeyError``, another shape ``ValueError``: template
    errors, not corruption) and every leaf comes back as a tensor of the
    template leaf's dtype on ``device`` (default: the port's, ``cuda``).
    With ``tree_like=None`` the nested dict is rebuilt from the stored key
    paths and the leaves stay host ``np.ndarray``s (a bf16 leaf, which
    numpy cannot hold, a host bf16 tensor), unless ``device`` is given.
    Either way the manifest is checked first: a corrupted leaf raises
    :class:`CheckpointIntegrityError` (``strict``) or is dropped and listed
    in ``meta["corrupt_keys"]``.

    With ``step=None`` the newest committed step is read; if it vanishes
    between the choice and the read (a concurrent retention ``_gc``), the
    next older committed step is.
    """
    if step is not None:
        flat, meta = _load_step(os.path.join(directory, f"step_{step:09d}"))
    else:
        steps = _committed_steps(directory)
        flat = meta = None
        for s in reversed(steps):
            try:
                flat, meta = _load_step(
                    os.path.join(directory, f"step_{s:09d}"))
                break
            except FileNotFoundError:
                continue             # _gc won the race for this step
        if flat is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    meta = dict(meta)
    meta["corrupt_keys"] = _validate(flat, meta, strict)
    manifest = meta.get("manifest") or {}

    def dtype_of(key):
        return manifest.get(key, {}).get("dtype", "")

    if tree_like is None:
        if device is None:
            flat = {k: (_tensor(v, dtype_of(k)) if _is_bf16(v, dtype_of(k))
                        else v) for k, v in flat.items()}
        else:
            dev = resolve_device(device)
            flat = {k: _tensor(v, dtype_of(k)).to(dev)
                    for k, v in flat.items()}
        return _unflatten_keys(flat), meta

    dev = resolve_device(device)
    leaves = {}
    for key, like in _items(tree_like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected "
                             f"{tuple(like.shape)}")
        t = _tensor(arr, dtype_of(key))
        want = (like.dtype if isinstance(like, torch.Tensor) else
                torch.from_numpy(np.zeros((), like.dtype)).dtype)
        leaves[key] = t.to(device=dev, dtype=want)
    return _rebuild(tree_like, leaves), meta


class CheckpointManager:
    """Keep-N retention and torn-write garbage collection."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
        path = save(self.directory, step, tree, metadata)
        self._gc()
        return path

    def restore(self, tree_like: Any = None, step: Optional[int] = None,
                device=None, strict: bool = True):
        return restore(self.directory, tree_like, step, device,
                       strict=strict)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        committed = sorted(
            n[:-len(_DONE)] for n in os.listdir(self.directory)
            if n.startswith("step_") and n.endswith(_DONE))
        for n in committed[:-self.keep] if self.keep else []:
            # marker first: a concurrent reader that listed it either still
            # finds the payload whole or, finding it gone, falls back to the
            # next older committed step, never a half-deleted read
            try:
                os.remove(os.path.join(self.directory, n + _DONE))
            except FileNotFoundError:
                pass
            shutil.rmtree(os.path.join(self.directory, n),
                          ignore_errors=True)
        # torn writes (no commit marker)
        for n in os.listdir(self.directory):
            full = os.path.join(self.directory, n)
            if n.endswith(".tmp"):
                shutil.rmtree(full, ignore_errors=True)
            elif (n.startswith("step_") and os.path.isdir(full)
                  and not os.path.exists(full + _DONE)):
                shutil.rmtree(full, ignore_errors=True)
