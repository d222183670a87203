"""Collectives over a ``torch.distributed`` process group, staged through
host memory where the backend will not take a device tensor.

The ranks of one card form a gloo group (NCCL refuses two ranks on one
device), and gloo sends and receives host tensors only. Each helper here
copies a CUDA tensor to the host before a gloo collective and back after
it, explicitly; with NCCL, or on host tensors, the tensor goes as it is.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["staged", "all_reduce_", "broadcast_", "exchange"]


def staged(t: torch.Tensor, group=None) -> bool:
    """Whether ``t`` must travel through host memory on ``group``."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group``, in place."""
    if staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` on every rank of ``group``, in place."""
    if staged(t, group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             recv: Optional[torch.Tensor], src: Optional[int],
             group=None) -> Optional[torch.Tensor]:
    """Post a send of ``send`` to global rank ``dst`` and a receive into
    ``recv`` from global rank ``src`` together (``batch_isend_irecv``), and
    wait for both; either may be ``None``. Returns ``recv``."""
    ops, back = [], None
    if send is not None:
        s = send.cpu() if staged(send, group) else send.contiguous()
        ops.append(dist.P2POp(dist.isend, s, dst, group))
    if recv is not None:
        r = torch.empty(recv.shape, dtype=recv.dtype) \
            if staged(recv, group) else recv
        back = r
        ops.append(dist.P2POp(dist.irecv, r, src, group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if recv is not None and back is not recv:
        recv.copy_(back)
    return recv
