"""The training step and the CNN's forward replayed from CUDA graphs.

The reference jits its training step: ``train()``'s (``train/loop.py``),
the launcher's (``launch/train.py``, the profile id passed as traced data
so one executable serves every profile) and the CNN's QAT step
(``benchmarks/repro_cnn.py``), and it jits the CNN's test-set forward
(``models/cnn.py``). The port's counterparts are :class:`TrainGraphs` and
:class:`CallGraphs`, built on :class:`~repro_torch.serving.graphs.
GraphSet` (the capture, its stream and the kernels' counters, shared with
the serving graphs).

:class:`TrainGraphs` holds one training lifetime (one ``train()`` call,
or one :func:`~repro_torch.launch.repro_cnn.train_profile`): one CUDA
graph of the step per profile id, captured on the id's first use (after
one real step on the capture stream) and replayed for every later step
under that id, all in one memory pool. A profile's bits choose which
weight sites are quantized and at what grid, so they are launch
parameters, not data: the lifetime holds at most ``P`` graphs where the
reference holds one executable. Every step stages the batch's host arrays
into fixed buffers with one pinned copy; the step writes the parameters,
the moments and the step counter in place (a step that returns new
tensors has them copied back inside the graph) and its metrics into fixed
output buffers, which the loop reads after the replay. The graphs serve
the tensors they were captured on: a lifetime refuses others.

:class:`CallGraphs` replays a function of a few tensors (the CNN's
forward) from one graph per input shape; :func:`~repro_torch.launch.
repro_cnn.measure_ms` times a replay, and :func:`~repro_torch.models.cnn.
cnn_accuracy` replays one graph per batch shape.

On CUDA a failed capture or replay raises; nothing falls back to the eager
step. Off CUDA a graph needs a capture stand-in (tests), which may return
the step itself so the staging and the bookkeeping run eagerly.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.serving.graphs import Capture, GraphSet

__all__ = ["TrainGraphs", "CallGraphs", "use_graphs", "on_device"]

_ALIGN = 16                   # bytes between the staged fields' starts


def use_graphs(graphs: Optional[bool], device: torch.device,
               capture: Optional[Capture]) -> bool:
    """Whether a step replays from graphs: ``graphs`` as given, by default
    on a CUDA device or under a capture stand-in."""
    if graphs is None:
        return capture is not None or device.type == "cuda"
    return bool(graphs)


def on_device(batch: dict, device: torch.device) -> dict:
    """``batch`` with its host arrays and tensors moved to ``device`` (the
    eager step's inputs); other entries (the profile id) as they are."""
    return {k: torch.as_tensor(v).to(device)
            if isinstance(v, (torch.Tensor, np.ndarray)) else v
            for k, v in batch.items()}


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


class _Inputs:
    """Fixed device buffers for a batch's arrays, views of one byte block,
    and its pinned host side: a batch of host arrays crosses in one
    asynchronous copy (synchronous off CUDA); an array already on the
    device is copied into its buffer there. The host side is rewritten
    only once the device has read it."""

    def __init__(self, like: dict, device: torch.device, cuda: bool):
        self.names = sorted(like)
        spans, at = [], 0
        for k in self.names:
            t = torch.as_tensor(like[k])
            n = t.numel() * t.element_size()
            spans.append((at, n, t.dtype, tuple(t.shape)))
            at += -(-n // _ALIGN) * _ALIGN
        self._block = torch.empty((max(at, 1),), dtype=torch.uint8,
                                  device=device)
        self._host = torch.empty((max(at, 1),), dtype=torch.uint8,
                                 pin_memory=cuda)
        self._cuda = cuda
        self._copied: Optional[torch.cuda.Event] = None

        def views(block):
            return {k: block[a:a + n].view(dt).view(shape)
                    for k, (a, n, dt, shape) in zip(self.names, spans)}
        self.bufs, self._hviews = views(self._block), views(self._host)

    def put(self, batch: dict) -> None:
        """``batch``'s arrays (the names, shapes and dtypes of the first)
        into the buffers."""
        if sorted(k for k, v in batch.items() if _is_array(v)) != self.names:
            raise ValueError(f"a training lifetime's graphs take the arrays "
                             f"{self.names}, got {sorted(batch)}")
        host = {}
        for k in self.names:
            t = torch.as_tensor(batch[k])
            buf = self.bufs[k]
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(f"a training lifetime's graphs take {k} "
                                 f"{tuple(buf.shape)} {buf.dtype}, got "
                                 f"{tuple(t.shape)} {t.dtype}")
            if t.device.type == "cpu":
                host[k] = t
            else:
                buf.copy_(t)
        if not host:
            return
        if self._copied is not None and not self._copied.query():
            self._copied.synchronize()     # in practice done: a step since
        for k, t in host.items():
            self._hviews[k].copy_(t)
        if len(host) == len(self.names):
            self._block.copy_(self._host, non_blocking=self._cuda)
        else:
            for k in host:
                self.bufs[k].copy_(self._hviews[k], non_blocking=self._cuda)
        if self._cuda:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self._block.device))


def _pairs(fixed, new):
    """The leaves of two trees of one structure (dicts, tuples), in
    order."""
    if isinstance(fixed, dict):
        for k in fixed:
            yield from _pairs(fixed[k], new[k])
    elif isinstance(fixed, tuple):
        for a, b in zip(fixed, new):
            yield from _pairs(a, b)
    else:
        yield fixed, new


def _ptrs(tree) -> tuple:
    return tuple(a.data_ptr() for a, _ in _pairs(tree, tree))


class TrainGraphs(GraphSet):
    """One training lifetime's step graphs, one per profile id (the
    ``profile_id`` entry of the batch, ``None`` for a batch without one:
    the keys of ``captured`` and ``used``). ``step(params, opt, batch) ->
    (params, opt, metrics)`` is the eager step; a step that draws from
    generators besides the default one names them in its ``generators``
    attribute and reseeds each to its seed at its start, and each replay
    is preceded by that reseed. ``runs`` counts the steps this lifetime
    ran, ``replays`` those that replayed. See :class:`~repro_torch.serving.
    graphs.GraphSet` for ``capture``."""

    def __init__(self, step: Callable, device: torch.device,
                 capture: Optional[Capture] = None):
        super().__init__(device, capture, "training step")
        self.step = step
        self.generators = tuple(getattr(step, "generators", ()))
        self.pool = self._new_pool()
        self.used: set = set()
        self.runs = 0
        self.metrics: Optional[dict] = None
        self._graphs: dict = {}
        self._inputs: Optional[_Inputs] = None
        self._bound: Optional[tuple] = None

    @property
    def inputs(self) -> dict:
        """The fixed batch buffers, by name."""
        return {} if self._inputs is None else self._inputs.bufs

    def _bind(self, params, opt) -> None:
        ptrs = _ptrs((params, opt))
        if self._bound is None:
            self._bound = ptrs
        elif ptrs != self._bound:
            raise ValueError("a training lifetime's graphs serve the "
                             "parameters and optimizer state they were "
                             "captured on; new tensors need a new "
                             "TrainGraphs")

    def run(self, params, opt, batch: dict):
        """One training step on ``batch`` (host or device arrays and the
        profile id): returns ``(params, opt, metrics)``, the first two the
        tensors given (updated in place) and ``metrics`` the fixed output
        buffers, valid until the next step."""
        self._bind(params, opt)
        arrays = {k: v for k, v in batch.items() if _is_array(v)}
        if self._inputs is None:
            self._inputs = _Inputs(arrays, self.device, self._cuda)
        self._inputs.put(arrays)
        key = batch.get("profile_id")
        self.used.add(key)
        self.runs += 1
        got = self._graphs.get(key)
        if got is not None:
            for gen in self.generators:
                gen.manual_seed(gen.initial_seed())
            self._replay(*got)
            return params, opt, self.metrics
        inp = {**batch, **self._inputs.bufs}

        def body() -> None:
            p, o, m = self.step(params, opt, inp)
            for a, b in _pairs((params, opt), (p, o)):
                if a is not b:
                    a.copy_(b)
            if self.metrics is None:          # the warm-up allocates them
                self.metrics = {k: torch.empty_like(v) for k, v in m.items()}
            for k, v in m.items():
                self.metrics[k].copy_(v)

        self._warm(body)                      # warm-up = this step
        if self._cuda:
            # the warm-up's cached blocks are released (cudaFree), so the pool
            # takes their place: the card holds one step's working set
            torch.cuda.empty_cache()
        self._graphs[key] = self._record(key, body, self.generators)
        return params, opt, self.metrics


class CallGraphs(GraphSet):
    """``fn(*xs) -> tensor`` replayed from one graph per input shape (the
    keys of ``captured`` and ``used``): a call copies ``xs`` into the
    key's fixed buffers and replays; its first call runs ``fn`` on the
    capture stream and captures it. The result is the graph's own output,
    valid until the next call of the same shape. See :class:`~repro_torch.
    serving.graphs.GraphSet` for ``capture``."""

    def __init__(self, fn: Callable, device: torch.device,
                 capture: Optional[Capture] = None):
        super().__init__(device, capture, "function")
        self.fn = fn
        self.pool = self._new_pool()
        self.used: set = set()
        self._graphs: dict = {}

    def __call__(self, *xs: torch.Tensor) -> torch.Tensor:
        key = tuple((tuple(x.shape), x.dtype) for x in xs)
        self.used.add(key)
        rec = self._graphs.get(key)
        if rec is not None:
            bufs, out, replay, delta = rec
            for b, x in zip(bufs, xs):
                b.copy_(x)
            self._replay(replay, delta)
            return out[0]
        bufs = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                .copy_(x) for x in xs]
        first = self._warm(lambda: self.fn(*bufs))
        out: list = [None]

        def body() -> None:
            out[0] = self.fn(*bufs)           # the graph's own output

        replay, delta = self._record(key, body)
        self._graphs[key] = (bufs, out, replay, delta)
        return first

