"""The continuous scheduler's decode segment replayed from CUDA graphs.

The reference compiles its segment once per pool lifetime (one ``jax.jit``
with the pool donated; the per-step profile id rides the scan as data), and
holds that as two named invariants, ``single-segment-executable`` and
``no-retrace``. The port's counterpart is :class:`SegmentGraphs`: one CUDA
graph of :func:`~repro_torch.models.transformer.segment_step` per profile
id, captured on the id's first use and replayed for every later step under
that id. Every tensor the step touches is a fixed buffer
(:func:`~repro_torch.models.transformer.segment_buffers`) or the pool
itself, written in place; the bf16 weight images a profile reads are
chosen by pointer, so a graph is keyed by the profile id, and a lifetime
holds at most ``P`` graphs where the reference holds one executable.

A pool lifetime is a scheduler's: the scheduler makes the pool and one
:class:`SegmentGraphs` beside it, and a new scheduler (such as
:func:`~repro_torch.serving.durability.recover`'s) starts with no graphs.
Rebinding the server's images, backend or precision policy also starts a
new lifetime. A segment
stages ``remaining`` and the fault operand in one host→device copy, resets
the step index and the finite check, then replays (or, on a profile's first
use, runs once on the capture stream and captures) one graph per step; a
segment longer than the buffers runs in chunks of their width, the staged
counts shifted on the device between chunks. On CUDA a failed capture or
replay raises; nothing falls back to the eager segment.

A speculative scheduler's segment is :class:`SpecSegmentGraphs`: one graph
of :func:`~repro_torch.models.transformer.segment_spec_step` (one
draft/verify window) per profile id, over the buffers of
:func:`~repro_torch.models.transformer.segment_spec_buffers`; a segment
stages ``remaining``, the fault operand, ``quota``, the opt-out mask and
the drafter history in one copy. The host keeps the history as its source
of truth and stages it anew every segment.

The static path (:meth:`~repro_torch.serving.engine.AdaptiveServer.
generate`, :meth:`~repro_torch.serving.engine.AdaptiveServer.
generate_stepwise`) keeps one :class:`StaticGraphs` per group shape
``(rows, slots, kv bits)`` for the server's life, with a contiguous cache
of that shape: the group's prefill replays from a graph per exact key
``("static" or "uniform", profile id, rows, maxlen, 0)`` and writes that
cache whole (nothing is copied into it), the decode steps replay from
one graph per profile id over it, and so does the stepwise oracle's
decode step (:class:`StepGraphs`, its logits read by the host). The three
share one lifetime, binding, capture stream and memory pool.

The scheduler's admission waves replay from :class:`WaveGraphs`, made
beside the segment graphs and living by the same lifetime rules: one graph
per wave key ``(kind, profile id, rows, prompt or suffix bucket, prefix
bucket)``, the counterpart of the reference's one ``jax.jit`` executable
per bucket shape (rows and lengths are powers of two, so the keys of a
lifetime stay few). A wave stages its host plan (prompts, lengths,
``slots_idx``, ``dest``, the block-table rows, the prefix lengths and block
ids) in one pinned copy into int32 buffers of its key's shape, fills its
prefix buffers on the device (a master-replay wave), and replays the
prefill or continuation, the argmax, the block scatter or row writes and
the carries' writes. The wave graphs of a lifetime share one memory pool;
a master wave's prefix buffers and every wave's raw K/V output are views
of flat buffers the lifetime's waves share, so a lifetime holds about its
largest wave's working set. A wave's outputs are read before the next
wave replays (the first tokens are cloned out).

The kernels' launch counters (``paged_attention.launches`` and the others
in :func:`counters`) move when a wrapper is called, which under capture is
once per graph and not once per launch. The capture's increments are taken
back and recorded per graph, and each replay adds them again, so a counter
reads the kernel's launches on the graphed path as on the eager one.
"""
from __future__ import annotations

import dataclasses
import gc
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.attention import PagedKVCache

__all__ = ["SegmentGraphs", "SpecSegmentGraphs", "WaveGraphs", "StepGraphs",
           "StaticGraphs", "WAVE_FIELDS", "cuda_capture", "counters",
           "graphable"]

Capture = Callable[[Callable[[], None], Optional[torch.cuda.Stream], object],
                   Callable[[], None]]

_STREAMS: dict = {}          # device index -> the capture stream


def counters() -> list:
    """``(function, attribute)`` of every launch and call counter a decode
    step can move: the five kernels' ``launches`` and the plain branches'
    counts (the dequantize-then-matmul branch, the routed experts'
    dequant, the gather view, the kv8 einsum)."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.models import attention as A
    from repro_torch.models import layers as LY
    from repro_torch.models import moe as MO
    return [(PA.paged_attention, "launches"),
            (PA.paged_attention_multi, "launches"),
            (QK.qkv_attention, "launches"), (QM.qmatmul, "launches"),
            (AQ.aquant, "launches"), (LY.dequant_matmul, "calls"),
            (MO.routed_dequant, "calls"), (A.paged_view, "calls"),
            (A.decode_attention, "kv8_einsum_calls")]


def _read(cs: list) -> list:
    return [getattr(f, a, 0) for f, a in cs]


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """One side stream per device for every capture: K5's per-stream
    workspace (``kernels/aquant.py::_workspace``) has a few slots, and a
    graph keeps the workspace of the stream it was captured on."""
    if dev.index not in _STREAMS:
        _STREAMS[dev.index] = torch.cuda.Stream(dev)
    return _STREAMS[dev.index]


def cuda_capture(step: Callable[[], None], stream: torch.cuda.Stream,
                 pool) -> Callable[[], None]:
    """Capture ``step`` into a CUDA graph on ``stream`` in memory pool
    ``pool`` and return its replay. Nothing runs: the caller has run the
    step once on ``stream`` (the warm-up that builds the kernels and the
    per-stream workspaces). The capture's own synchronize is allowed
    through a sync-debug mode of ``"error"``. Python's garbage collector
    is held off while the capture runs: an unreachable cycle that holds
    another graph would otherwise be freed mid-capture, and its memory
    released into the capture invalidates it."""
    g = torch.cuda.CUDAGraph()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(g, pool=pool, stream=stream):
            step()
    finally:
        if collecting:
            gc.enable()
        torch.cuda.set_sync_debug_mode(mode)
    return g.replay


def graphable(srv) -> bool:
    """Whether ``srv``'s segments can replay from graphs: a paged pool only
    on the kernel backend (the gather backend's dense view is made per
    segment; it is the kernel's oracle and stays eager)."""
    return not (srv.cfg.has_attn and srv.scfg.paged_kv
                and srv.paged_backend != "kernel")


def _leaves(caches: dict) -> tuple:
    out = []
    for key in sorted(caches):
        c = caches[key]
        for f in dataclasses.fields(c):
            x = getattr(c, f.name)
            if isinstance(x, torch.Tensor):
                out.append((key, f.name, x.data_ptr()))
    return tuple(out)


class _Staged:
    """A fixed int32 device block and its pinned host side: a call's host
    arrays cross in one asynchronous copy (synchronous off CUDA). The host
    side is rewritten only once the device has read it."""

    def __init__(self, block: torch.Tensor, cuda: bool):
        self.block = block
        self._cuda = cuda
        self._host = torch.zeros(block.shape, dtype=torch.int32,
                                 pin_memory=cuda)
        self._copied: Optional[torch.cuda.Event] = None

    def put(self, rows: list) -> None:
        """``rows`` (host arrays, each filling its slice in order) into
        the block."""
        if self._copied is not None and not self._copied.query():
            self._copied.synchronize()     # in practice done: a flush since
        host = self._host.view(-1)
        at = 0
        for r in rows:
            r = np.asarray(r).reshape(-1)
            host[at:at + r.size] = torch.from_numpy(r.astype(np.int32))
            at += r.size
        self.block.copy_(self._host, non_blocking=self._cuda)
        if self._cuda:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.block.device))


class _Graphs:
    """What a pool lifetime's graph sets share: the capture (``capture``,
    default :func:`cuda_capture`, which needs the server on a CUDA device;
    a stand-in (tests) may return the step itself, so the bookkeeping runs
    eagerly on the CPU), the lifetime and what binds it, the capture
    stream, one memory pool, and the counters' bookkeeping.

    ``captured`` lists the keys captured in this lifetime, in order, and
    ``used`` the keys run; ``lifetimes`` counts the lifetimes begun on
    this object (the first included); ``replays`` the graph replays.

    ``lead`` (another set on the same server and capture) makes this set
    follow it: the lead's memory pool, and a new lifetime whenever the
    lead begins one."""

    def __init__(self, srv, capture: Optional[Capture] = None,
                 lead: Optional["_Graphs"] = None):
        dev = srv.device
        if capture is None:
            if dev.type != "cuda":
                raise ValueError(f"CUDA graphs need a CUDA device, the "
                                 f"server is on {dev}")
            capture = cuda_capture
        self.srv = srv
        self.device = dev
        self._capture = capture
        self._cuda = dev.type == "cuda"
        self._lead = lead
        self.lifetimes = 0
        self.captured: list = []
        self.replays = 0
        self._new_lifetime()

    # ---------------------------------------------------------- lifetime
    def _binding(self) -> tuple:
        """What a graph reads by pointer or bakes in: the server's weight
        images, backend and precision policy."""
        srv = self.srv
        return (srv.prequant, srv.paged_backend, srv.kv_table)

    def _new_lifetime(self) -> None:
        self._graphs: dict = {}
        self.captured = []
        self.used: set = set()
        lead = self._lead
        if lead is not None:
            self.pool, self._lead_life = lead.pool, lead.lifetimes
        else:
            self.pool = (torch.cuda.graph_pool_handle() if self._capture is
                         cuda_capture else None)
        self._bound = self._binding()
        self._pool_leaves = None
        self.lifetimes += 1

    def _refresh(self) -> None:
        """A new lifetime if the binding moved (a follower: once its lead
        has begun one)."""
        lead = self._lead
        if lead is not None:
            lead._refresh()
            if lead.lifetimes != self._lead_life:
                self._new_lifetime()
        elif any(a != b if isinstance(a, str) else a is not b
                 for a, b in zip(self._binding(), self._bound)):
            self._new_lifetime()

    def _check_bound(self, caches: dict, *carries: torch.Tensor) -> None:
        self._refresh()
        leaves = _leaves(caches) + tuple(x.data_ptr() for x in carries)
        if self._pool_leaves is None:
            self._pool_leaves = leaves
        elif leaves != self._pool_leaves:
            raise ValueError("a pool lifetime's graphs serve the pool they "
                             "were captured on; a new pool needs a new "
                             f"{type(self).__name__}")

    def capture_count(self) -> int:
        """Graphs captured in this pool lifetime."""
        return len(self.captured)

    # ----------------------------------------------------- capture, replay
    def _warm(self, fn: Callable):
        """Run ``fn`` for real on the capture stream (the warm-up that
        builds the kernels and the per-stream workspaces; off CUDA, here)
        and return what it returns."""
        if not self._cuda:
            return fn()
        stream = _capture_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
        return out

    def _record(self, key, step: Callable[[], None]) -> tuple:
        """Capture ``step`` as ``key``'s graph: ``(replay, counter
        increments per replay)``. Nothing runs; the increments the capture
        made are taken back."""
        stream = _capture_stream(self.device) if self._cuda else None
        cs = counters()
        before = _read(cs)
        replay = self._capture(step, stream, self.pool)
        after = _read(cs)
        for (f, a), v in zip(cs, before):
            if hasattr(f, a):
                setattr(f, a, v)                     # nothing ran
        self.captured.append(key)
        return replay, [x - y for x, y in zip(after, before)]

    def _replay(self, replay: Callable[[], None], delta: list) -> None:
        replay()
        self.replays += 1
        for (f, a), d in zip(counters(), delta):
            if d:
                setattr(f, a, getattr(f, a) + d)


class SegmentGraphs(_Graphs):
    """One pool lifetime's decode-step graphs, one per profile id (the
    keys of ``captured`` and ``used``); see :class:`_Graphs` for
    ``capture`` and the bookkeeping."""

    def __init__(self, srv, batch: int, quantum: int,
                 capture: Optional[Capture] = None):
        super().__init__(srv, capture)
        self.buf = self._buffers(batch, quantum)
        self._staged = _Staged(self.buf["inp"], self._cuda)

    def _buffers(self, batch: int, quantum: int) -> dict:
        return T.segment_buffers(batch, quantum, self.device)

    # ------------------------------------------------------------- steps
    def _step_fn(self, pid: int, caches: dict) -> Callable[[], None]:
        srv, buf = self.srv, self.buf
        params = srv.profile_params(pid)
        bits, ks = srv.engine.table[pid], srv.kv_sched(pid)
        backend = srv.paged_backend

        def step() -> None:
            T.segment_step(params, srv.cfg, bits, buf, caches,
                           paged_backend=backend, kv_sched=ks)
        return step

    def _run_step(self, pid: int, caches: dict) -> None:
        self.used.add(pid)
        got = self._graphs.get(pid)
        if got is not None:
            self._replay(*got)
            return
        step = self._step_fn(pid, caches)
        self._warm(step)                             # warm-up = this step
        self._graphs[pid] = self._record(pid, step)

    def _carries(self, tok: torch.Tensor, pos: torch.Tensor,
                 caches: dict) -> None:
        self._check_bound(caches)
        buf = self.buf
        if tok is not buf["tok"]:
            buf["tok"].copy_(tok)
        if pos is not buf["pos"]:
            buf["pos"].copy_(pos)

    def run(self, schedule, tok: torch.Tensor, pos: torch.Tensor,
            caches: dict, remaining, fault_step=None):
        """One decode segment of ``len(schedule)`` steps, as
        :func:`~repro_torch.models.transformer.decode_segment` on the
        kernel backend: returns ``(tokens [B, steps], row_ok [B], tok, pos,
        caches)``, where ``tok``/``pos`` are the fixed buffers (the caller
        keeps them, and writes its admissions there). A segment longer
        than the buffers runs in chunks of their width: between chunks
        ``rem`` and ``fs`` drop by the width on the device, so ``rem > i``
        and ``fs == i`` keep reading the segment's step index."""
        self.stage(tok, pos, caches, remaining, fault_step)
        return self.replay(schedule, caches)

    def stage(self, tok: torch.Tensor, pos: torch.Tensor, caches: dict,
              remaining, fault_step=None) -> None:
        """The first half of :meth:`run`: the carries into the buffers,
        ``remaining`` and the fault operand staged, the finite check
        reset."""
        self._carries(tok, pos, caches)
        b = self.buf["tok"].shape[0]
        self._staged.put([remaining, np.full((b,), -1)
                          if fault_step is None else fault_step])
        self.buf["ok"].fill_(True)

    def replay(self, schedule, caches: dict):
        """The second half of :meth:`run`: replay ``schedule``'s steps."""
        schedule = np.asarray(schedule).reshape(-1)
        buf = self.buf
        steps, width = len(schedule), buf["out"].shape[1]
        kv = caches.get("kv")
        finish = None
        if isinstance(kv, PagedKVCache):
            rem = buf["rem"]
            finish = (rem > 0) & (rem <= steps)
        outs = []
        for c0 in range(0, steps, width):
            part = schedule[c0:c0 + width]
            if c0:
                buf["rem"].sub_(width)
                buf["fs"].sub_(width)
            buf["i"].zero_()
            for pid in part:
                self._run_step(int(pid), caches)
            outs.append(buf["out"][:, :len(part)].clone())   # reused next chunk
        if finish is not None:
            kv.block_table.masked_fill_(finish[None, :, None], kv.n_blocks)
        toks = torch.cat(outs, dim=1) if outs else buf["out"][:, :0].clone()
        return toks, buf["ok"].clone(), buf["tok"], buf["pos"], caches


class SpecSegmentGraphs(SegmentGraphs):
    """One pool lifetime's draft/verify window graphs, one per profile id:
    the speculative twin of :class:`SegmentGraphs` (same lifetime, capture
    stream, memory pool and counters). ``n_iter`` windows of ``draft_k +
    1`` tokens per segment, a drafter history of ``hist`` tokens; the
    server's drafter (``srv.draft_fn``, or the n-gram drafter) is baked
    into the graphs, so rebinding it starts a new lifetime. A drafter that
    synchronizes makes the capture raise."""

    def __init__(self, srv, batch: int, n_iter: int, draft_k: int,
                 hist: int, capture: Optional[Capture] = None):
        self.draft_k = int(draft_k)
        self._hist_len = int(hist)
        super().__init__(srv, batch, n_iter, capture)

    def _buffers(self, batch: int, n_iter: int) -> dict:
        return T.segment_spec_buffers(batch, n_iter, self.draft_k + 1,
                                      self._hist_len, self.device)

    def _binding(self) -> tuple:
        return super()._binding() + (self.srv.draft_fn,)

    def _step_fn(self, pid: int, caches: dict) -> Callable[[], None]:
        srv, buf = self.srv, self.buf
        params = srv.profile_params(pid)
        bits, backend = srv.engine.table[pid], srv.paged_backend
        k, draft_fn = self.draft_k, srv.draft_fn

        def step() -> None:
            T.segment_spec_step(params, srv.cfg, bits, buf, caches,
                                paged_backend=backend, draft_k=k,
                                draft_fn=draft_fn)
        return step

    def run(self, schedule, hist, spec_on, tok: torch.Tensor,
            pos: torch.Tensor, caches: dict, remaining, quota,
            fault_step=None):
        """One speculative segment of ``len(schedule)`` windows, as
        :func:`~repro_torch.models.transformer.decode_segment_spec` on the
        kernel backend (the server's drafter, no override): returns
        ``(tokens [B, n_iter, W], delivered [B, n_iter], row_ok [B], tok,
        pos, caches)``, where ``tok``/``pos`` are the fixed buffers."""
        schedule = np.asarray(schedule).reshape(-1)
        buf = self.buf
        n_iter = len(schedule)
        if n_iter > buf["ms"].shape[1]:
            raise ValueError(f"a segment of {n_iter} windows exceeds the "
                             f"buffers' {buf['ms'].shape[1]}")
        self._carries(tok, pos, caches)
        b = buf["tok"].shape[0]
        rem = np.asarray(remaining)
        self._staged.put([hist, rem, rem,
                          np.full((b,), -1) if fault_step is None
                          else fault_step,
                          quota, np.asarray(spec_on, bool)])
        buf["i"].zero_()
        buf["ok"].fill_(True)
        for pid in schedule:
            self._run_step(int(pid), caches)
        kv = caches.get("kv")
        if isinstance(kv, PagedKVCache):
            finish = (buf["rem0"] > 0) & (buf["rem"] <= 0)
            kv.block_table.masked_fill_(finish[None, :, None], kv.n_blocks)
        return (buf["out"][:, :n_iter].clone(), buf["ms"][:, :n_iter].clone(),
                buf["ok"].clone(), buf["tok"], buf["pos"], caches)


# a wave kind's staged plan, in order: the kinds are the server's wave
# bodies (AdaptiveServer.wave): a cold wave into the contiguous pool, a cold
# paged wave, the continuation over prefix blocks gathered from a bf16 pool
# or over replayed f32 masters, and the static path's prefill of a ragged
# group or of a uniform batch (no lengths) into its kept cache
WAVE_FIELDS = {
    "cold": ("prompts", "plen", "sidx"),
    "paged": ("prompts", "plen", "sidx", "dest"),
    "pool": ("prompts", "plen", "sidx", "dest", "bt", "pre_len", "pre_bids"),
    "master": ("prompts", "plen", "sidx", "dest", "bt", "pre_len"),
    "static": ("prompts", "plen"),
    "uniform": ("prompts",),
}


@dataclasses.dataclass
class _Wave:
    """One wave key's graph: its staged plan (views of one int32 block),
    its prefix buffers (a master wave), the replay with its counter
    increments, and its outputs."""

    staged: _Staged
    plan: dict
    prefix: Optional[tuple]
    replay: Optional[Callable[[], None]] = None
    delta: Optional[list] = None
    tok0: Optional[torch.Tensor] = None
    raw: Optional[tuple] = None


class WaveGraphs(_Graphs):
    """One pool lifetime's admission-wave graphs, one per wave key ``(kind,
    profile id, rows a, prompt or suffix bucket, prefix bucket)`` (the
    keys of ``captured`` and ``used``): the counterpart of the reference's
    one executable per bucket shape. A key's first wave runs for real on
    the capture stream and is then captured; every later wave of the key
    replays. See :class:`_Graphs` for ``capture`` and the bookkeeping."""

    def _new_lifetime(self) -> None:
        super()._new_lifetime()
        self._arena: dict = {}          # (role, dtype) -> flat buffer

    def _view(self, role: str, shape: tuple, dtype: torch.dtype):
        """A view of ``shape`` into the lifetime's flat ``role`` buffer,
        grown (to a power of two) when a wave needs more; the waves of a
        key keep the buffer they were captured on."""
        n = math.prod(shape)
        flat = self._arena.get((role, dtype))
        if flat is None or flat.numel() < n:
            flat = torch.zeros((1 << max(0, n - 1).bit_length(),),
                               dtype=dtype, device=self.device)
            self._arena[(role, dtype)] = flat
        return flat[:n].view(shape)

    def _new_wave(self, kind: str, plan: dict, pp: int) -> _Wave:
        fields = WAVE_FIELDS[kind]
        shapes = [tuple(np.shape(plan[f])) for f in fields]
        block = torch.zeros((sum(math.prod(x) for x in shapes),),
                            dtype=torch.int32, device=self.device)
        views, at = {}, 0
        for f, shape in zip(fields, shapes):
            n = math.prod(shape)
            views[f] = block[at:at + n].view(shape)
            at += n
        prefix = None
        if kind == "master":
            cfg, a = self.srv.cfg, shapes[0][0]
            kv = (cfg.n_layers, a, pp, cfg.n_kv, cfg.hd)
            am = (cfg.n_layers, a, cfg.n_kv)
            prefix = (self._view("pk", kv, torch.float32),
                      self._view("pv", kv, torch.float32),
                      self._view("ka", am, torch.float32),
                      self._view("va", am, torch.float32))
        return _Wave(_Staged(block, self._cuda), views, prefix)

    def key(self, kind: str, pid: int, plan: dict, pp: int = 0) -> tuple:
        """The wave key of a plan: ``pp`` (the prefix bucket in tokens) is
        given for a master wave and read off ``pre_bids`` for a pool
        wave."""
        a, s = np.shape(plan["prompts"])
        if kind == "pool":
            pp = np.shape(plan["pre_bids"])[1] * self.srv.block_size
        elif kind != "master":
            pp = 0
        return (kind, int(pid), int(a), int(s), int(pp))

    def run(self, kind: str, pid: int, plan: dict, tok: torch.Tensor,
            pos: torch.Tensor, caches: dict, pre=(), pp: int = 0):
        """One admission wave of ``kind`` (:data:`WAVE_FIELDS`) under
        profile ``pid``, as :meth:`~repro_torch.serving.engine.
        AdaptiveServer.wave` with ``plan``'s host arrays and, for a master
        wave, the prefix operands of ``pre`` (one ``(n_tok, mk, mv, ka,
        va)`` per wave row, :func:`~repro_torch.models.transformer.
        prefix_operands`) padded to ``pp`` tokens. Returns ``(tok0 [a],
        raw)``: ``tok0`` a tensor of its own, ``raw`` the wave's raw K/V
        (or ``None``), valid until the next wave."""
        self._check_bound(caches, tok, pos)
        key = self.key(kind, pid, plan, pp)
        self.used.add(key)
        rec = self._graphs.get(key)
        if rec is None:
            rec = self._graphs[key] = self._new_wave(kind, plan, key[-1])
        rec.staged.put([plan[f] for f in WAVE_FIELDS[kind]])
        if rec.prefix is not None:
            T.prefix_operands(self.srv.cfg, key[2], key[-1], pre,
                              self.device, out=rec.prefix)
        if rec.replay is not None:
            self._replay(rec.replay, rec.delta)
            return rec.tok0.clone(), rec.raw
        srv = self.srv

        def body():
            return srv.wave(kind, pid, rec.plan, tok, pos, caches,
                            prefix=rec.prefix)

        tok0, raw = self._warm(body)
        if raw is not None:
            rec.raw = tuple(self._view(r, tuple(x.shape), x.dtype)
                            for r, x in zip(("rk", "rv"), raw))

        def step() -> None:
            t, r = body()
            rec.tok0 = t                  # the graph's own output buffer
            for out, x in zip(rec.raw or (), r or ()):
                out.copy_(x)

        rec.replay, rec.delta = self._record(key, step)
        return tok0, raw


class StepGraphs(_Graphs):
    """The stepwise oracle's decode step
    (:func:`~repro_torch.models.transformer.decode_step`, every row live)
    over a contiguous cache, one graph per profile id (the keys of
    ``captured`` and ``used``): a step stages its ``tok [B, 1]`` and ``pos
    [B]`` in one pinned copy and replays; its logits land in the fixed
    buffer ``logits``, which the caller reads. See :class:`_Graphs` for
    ``capture``, ``lead`` and the bookkeeping."""

    def __init__(self, srv, batch: int, capture: Optional[Capture] = None,
                 lead: Optional[_Graphs] = None):
        super().__init__(srv, capture, lead)
        self.inp = torch.zeros((2, batch), dtype=torch.int32,
                               device=self.device)
        self._staged = _Staged(self.inp, self._cuda)
        self.logits: Optional[torch.Tensor] = None

    def run(self, pid: int, tok, pos, caches: dict) -> torch.Tensor:
        """One decode step under profile ``pid`` from the host's ``tok
        [B, 1]`` and ``pos [B]``, updating ``caches`` in place: returns
        the logits buffer ``[B, V]``."""
        self._check_bound(caches)
        self._staged.put([tok, pos])
        self.used.add(pid)
        got = self._graphs.get(pid)
        if got is not None:
            self._replay(*got)
            return self.logits
        srv = self.srv
        params = srv.profile_params(pid)
        bits, ks = srv.engine.table[pid], srv.kv_sched(pid)
        tok_b, pos_b = self.inp[0].view(-1, 1), self.inp[1]

        def step() -> None:
            logits, _ = T.decode_step(params, srv.cfg, bits, tok_b, pos_b,
                                      caches, paged_backend=srv.paged_backend,
                                      kv_sched=ks)
            if self.logits is None:           # the warm-up allocates it
                self.logits = torch.empty_like(logits)
            self.logits.copy_(logits)

        self._warm(step)                             # warm-up = this step
        self._graphs[pid] = self._record(pid, step)
        return self.logits


class StaticGraphs(SegmentGraphs):
    """The static path's graphs of one group shape ``(rows, slots, kv
    bits)``, kept by the server for its life with the shape's contiguous
    cache ``kept`` (made once, empty): the decode steps (this set, one
    graph per profile id, chunks of ``quantum`` steps), the group's
    prefill (``prefill``, a :class:`WaveGraphs` keyed ``("static",
    profile id, rows, maxlen, 0)`` for a ragged group and ``("uniform",
    ...)`` for a batch without lengths, one graph per exact key), and the
    stepwise oracle's step (``steps``, a :class:`StepGraphs`). The prefill
    and the step follow this set (its lifetime and memory pool)."""

    def __init__(self, srv, rows: int, quantum: int,
                 capture: Optional[Capture] = None):
        super().__init__(srv, rows, quantum, capture)
        scfg = srv.scfg
        self.kept = T.init_caches(srv.cfg, rows, scfg.slots,
                                  kv_bits=scfg.kv_bits, device=self.device)
        self.prefill = WaveGraphs(srv, capture, lead=self)
        self.steps = StepGraphs(srv, rows, capture, lead=self)

    def parts(self) -> tuple:
        """The set's graph sets: prefill, decode, step."""
        return self.prefill, self, self.steps

    def prefill_group(self, pid: int, prompts, prompt_len=None):
        """The group's prefill under profile ``pid`` (host ints; without
        ``prompt_len`` a uniform batch) from its key's graph: ``kept``
        then holds the group's cache, and ``buf["tok"]``/``buf["pos"]``
        its first tokens and ``pos0``. Returns the first tokens ``[rows]``
        int32, a tensor of their own."""
        plan, kind = {"prompts": prompts}, "uniform"
        if prompt_len is not None:
            plan["plen"], kind = prompt_len, "static"
        return self.prefill.run(kind, pid, plan, self.buf["tok"],
                                self.buf["pos"], self.kept)[0]
