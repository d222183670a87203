"""Parameter conversion from the JAX reference's pytree.

:func:`params_from_jax` takes the reference's parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and
returns the port's tree, leaf for leaf — both packages keep the same stacked
``[L, ...]`` layout. The reference's native ``QTensor`` leaves (from
``to_native``) become the port's :class:`~repro_torch.core.quantizers.
QTensor`, recognised by their fields. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizers import QTensor
from repro_torch.runtime import resolve_device

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One leaf. A bfloat16 array (ml_dtypes, which ``torch.from_numpy``
    rejects) travels bit for bit through an int16 view."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_jax(tree, device=None):
    """Convert a nested dict (or list) of numpy arrays, and native
    ``QTensor`` leaves, to torch tensors on ``device`` (CUDA unless
    ``device="cpu"``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if getattr(tree, "_fields", None) == QTensor._fields:
        return QTensor(tensor_from_numpy(tree.data, device),
                       tensor_from_numpy(tree.scale, device),
                       int(tree.bits), int(tree.orig_last))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
