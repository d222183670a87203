"""Invariant checks over a recorded trace of aten operations.

Port of ``repro/analysis/jaxpr_check.py``. Where the reference walks the
equations of a traced jaxpr, :func:`trace_ops` runs the function eagerly
under a ``TorchDispatchMode`` and records one :class:`OpRecord` per aten
op that reaches the dispatcher: its name and each output's shape, dtype,
device and bytes, and whether the output aliases an input (a view or an
in-place update, per the op's schema). Over that record:

- :func:`max_out_bytes` / :func:`check_bytes_budget` — the largest
  materialized output, every output over a ceiling (aliases are not
  allocations and do not count);
- :func:`forbid_shape` / :func:`has_adjacent_dims` — outputs of a given
  shape, e.g. the ``[B, n_lblk·bs]`` gather view (aliases count: a
  reshape to the view's shape is the view);
- :func:`count_ops` — a histogram of op names;
- :func:`count_transfers` — device→host reads (``aten._local_scalar_dense``
  from ``.item()``/``int()``/``bool()`` of a tensor, the ops whose output
  shape depends on the data, such as ``nonzero``, and copies to the CPU)
  and host→device copies, counted apart. ``_local_scalar_dense`` and the
  data-dependent ops count whatever the device: on the card each one is
  a wait for the device. A ``torch.tensor``/``torch.as_tensor`` of Python
  data built on the device copies below the dispatcher; its one
  dispatched op, ``aten.lift_fresh``, already holds a device tensor, and
  counts as the host→device copy it stands for;
- :func:`verify_in_place` — the counterpart of ``verify_donation``: each
  carry keeps its storage (``data_ptr()``) across the call, and nothing of
  a carry's size or larger is allocated during it.

What the record cannot see: a hand-written kernel launched through
``ctypes`` is not an aten op, so only its wrapper's allocations (its
output, its split workspace) appear, not the kernel itself.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OutSpec", "OpRecord", "OpTrace", "Violation", "Transfers",
           "InPlaceReport", "trace_ops", "max_out_bytes",
           "check_bytes_budget", "forbid_shape", "has_adjacent_dims",
           "count_ops", "count_transfers", "verify_in_place"]

_COPY_OPS = {"aten._to_copy", "aten.copy_", "aten._copy_from",
             "aten._copy_from_and_resize"}
# A tensor made from Python data (``torch.tensor``, ``torch.as_tensor`` of
# a list or a scalar): on a device, the copy from the host ran below the
# dispatcher and this op sees its result.
_LIFT_OPS = {"aten.lift_fresh", "aten.lift_fresh_copy"}
# Ops that read a device value on the host: a scalar read, or an output
# whose shape depends on the data.
_READ_OPS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten._unique2", "aten.unique_dim", "aten.unique_consecutive",
             "aten.repeat_interleave"}
# An allocation of this share of the smallest carry's bytes or more, inside
# a call checked by verify_in_place, counts as a copy of a carry.
_COPY_FRACTION = 0.5


@dataclass(frozen=True)
class OutSpec:
    shape: tuple
    dtype: str
    device: str
    nbytes: int
    alias: bool          # a view of or an in-place update to an input


@dataclass(frozen=True)
class OpRecord:
    op: str              # "aten.add.Tensor"
    outputs: tuple       # OutSpec per tensor output
    in_devices: tuple    # device type of each tensor argument, in order

    @property
    def packet(self) -> str:
        """The op's name without its overload: ``aten.add``."""
        return self.op.rsplit(".", 1)[0] if self.op.count(".") > 1 else self.op


@dataclass
class OpTrace:
    """The records of one :func:`trace_ops` call, and the call's result."""

    records: list
    result: Any = None

    def __iter__(self):
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)


def _dev(t: torch.Tensor) -> str:
    return t.device.type


class _Recorder(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.records: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = tuple(_dev(a) for a in tree_flatten((args, kwargs))[0]
                    if isinstance(a, torch.Tensor))
        # recorded before the op runs, so an op that raises (a copy out of a
        # meta tensor) is still seen; its outputs are filled in after
        idx = len(self.records)
        name = str(func)
        self.records.append(OpRecord(name, (), ins))
        out = func(*args, **kwargs)
        aliases = [r.alias_info is not None for r in func._schema.returns]
        flat = out if isinstance(out, (tuple, list)) else (out,)
        specs = []
        for i, t in enumerate(flat):
            if not isinstance(t, torch.Tensor):
                continue
            specs.append(OutSpec(tuple(t.shape), str(t.dtype).replace(
                "torch.", ""), _dev(t), t.numel() * t.element_size(),
                bool(aliases[min(i, len(aliases) - 1)]) if aliases else False))
        self.records[idx] = OpRecord(name, tuple(specs), ins)
        return out


def trace_ops(fn: Callable, *args, **kwargs) -> OpTrace:
    """Run ``fn(*args, **kwargs)`` eagerly, recording every aten op."""
    rec = _Recorder()
    with rec:
        result = fn(*args, **kwargs)
    return OpTrace(rec.records, result)


def _records(trace) -> Iterable[OpRecord]:
    return trace.records if isinstance(trace, OpTrace) else trace


@dataclass(frozen=True)
class Violation:
    op: str
    shape: tuple
    dtype: str
    nbytes: int

    def render(self) -> str:
        return f"{self.op}: {self.dtype}{list(self.shape)} = {self.nbytes:,} bytes"


def _allocations(trace) -> Iterable[tuple[OpRecord, OutSpec]]:
    for r in _records(trace):
        for o in r.outputs:
            if not o.alias:
                yield r, o


def max_out_bytes(trace) -> int:
    """Largest materialized output (in bytes) anywhere in the trace."""
    return max((o.nbytes for _, o in _allocations(trace)), default=0)


def check_bytes_budget(trace, budget_bytes: int) -> list[Violation]:
    """Every materialized output whose size exceeds ``budget_bytes``."""
    return [Violation(r.op, o.shape, o.dtype, o.nbytes)
            for r, o in _allocations(trace) if o.nbytes > budget_bytes]


def forbid_shape(trace, pred: Callable[[tuple], bool]) -> list[Violation]:
    """Every output (views included) whose shape satisfies ``pred``."""
    return [Violation(r.op, o.shape, o.dtype, o.nbytes)
            for r in _records(trace) for o in r.outputs
            if o.shape and pred(o.shape)]


def has_adjacent_dims(trace, dims: tuple[int, ...]) -> bool:
    """True if any output has ``dims`` as a run of adjacent dimensions.

    This is the gather-view signature: the materialized paged view is
    ``[B, n_lblk*bs, Hkv, ...]``-shaped (batch adjacent to the padded slot
    count), which the in-place kernel path must never produce. The
    reference matches the pair ``(B, n_lblk*bs)``; an eager decode step
    flattens its ``[B, 1, F]`` activations to ``[B, F]``, so a pair can
    meet an MLP width, and the port matches ``(B, n_lblk*bs, Hkv)``.
    """
    dims = tuple(dims)
    n = len(dims)

    def pred(shape: tuple) -> bool:
        return any(tuple(shape[i:i + n]) == dims
                   for i in range(len(shape) - n + 1))

    return bool(forbid_shape(trace, pred))


def count_ops(trace) -> Counter:
    """Histogram of op names (overloads merged) over the trace."""
    return Counter(r.packet for r in _records(trace))


@dataclass(frozen=True)
class Transfers:
    d2h: int             # device→host reads and copies
    h2d: int             # host→device copies

    @property
    def total(self) -> int:
        return self.d2h + self.h2d


def count_transfers(trace) -> Transfers:
    """Device→host and host→device transfers in the trace, counted apart."""
    d2h = h2d = 0
    for r in _records(trace):
        name = r.packet
        if name in _READ_OPS:
            d2h += 1
            continue
        outs = {o.device for o in r.outputs}
        if name in _LIFT_OPS:
            h2d += bool(outs - {"cpu"})
            continue
        if name not in _COPY_OPS:
            continue
        ins = set(r.in_devices)
        if "cpu" in ins and outs - {"cpu"}:
            h2d += 1
        elif ins - {"cpu"} and (not outs or outs == {"cpu"}):
            d2h += 1            # not outs: the copy raised (a meta source)
    return Transfers(d2h, h2d)


@dataclass(frozen=True)
class InPlaceReport:
    moved: tuple         # names of carries whose storage changed
    allocations: tuple   # Violations: allocations of a carry's size or more
    trace: OpTrace

    @property
    def ok(self) -> bool:
        return not self.moved and not self.allocations

    def render(self) -> str:
        lines = [f"in place: {'ok' if self.ok else 'FAIL'}"]
        lines += [f"    carry {n!r} moved to new storage" for n in self.moved]
        lines += [f"    allocated {v.render()}" for v in self.allocations[:5]]
        return "\n".join(lines)


def _carry_leaves(carries) -> list[tuple[str, torch.Tensor]]:
    if isinstance(carries, torch.Tensor):
        return [("0", carries)]
    if isinstance(carries, Mapping):
        items = list(carries.items())
    elif isinstance(carries, Sequence):
        items = list(enumerate(carries))
    else:                                   # a dataclass of tensors
        items = [(k, v) for k, v in vars(carries).items()]
    return [(str(k), v) for k, v in items if isinstance(v, torch.Tensor)]


def verify_in_place(fn: Callable, carries, *args, after=None,
                    **kwargs) -> InPlaceReport:
    """Run ``fn(*args, **kwargs)`` under :func:`trace_ops` and check that
    every tensor of ``carries`` (a tensor, a mapping, a sequence or a
    dataclass of tensors) keeps its ``data_ptr()`` across the call, and
    that no op allocates an output of half the smallest carry's bytes or
    more (a copy of a carry). ``after(result)`` gives the
    carries after the call in the same structure, where ``fn`` returns
    them (default: the same objects). The counterpart of the reference's
    ``verify_donation``: there a donated carry's buffer is aliased to the
    output, here the carry is updated where it lies.

    Pass a stacked pool as its per-layer slices (``pool.k[l]``): a layer's
    copy is then the allocation caught."""
    leaves = _carry_leaves(carries)
    before = {n: t.data_ptr() for n, t in leaves}
    trace = trace_ops(fn, *args, **kwargs)
    now = dict(_carry_leaves(carries if after is None else after(trace.result)))
    moved = tuple(n for n, _ in leaves
                  if n not in now or now[n].data_ptr() != before[n])
    sizes = [t.numel() * t.element_size() for _, t in leaves if t.numel()]
    allocs = () if not sizes else tuple(check_bytes_budget(
        trace, int(_COPY_FRACTION * min(sizes)) - 1))
    return InPlaceReport(moved, allocs, trace)
