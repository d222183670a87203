"""The reduction of a profiler trace to what the per-layer metrics read.

The traced run keeps ``torch.profiler`` (CPU and CUDA activities) on for a
bounded slice of the window, marked by one ``pb.slice`` span that ends
with a device synchronise. From the trace this takes the slice's host
interval and every device operation in it (kernels, copies, fills), and
works out: the union of their intervals (busy time), the device time of
each kernel name, and the idle gaps, each named by the innermost host
operation of the harness's thread that was running at the gap's middle."""
from __future__ import annotations

import heapq
from collections import defaultdict

__all__ = ["SLICE", "Trace", "reduce", "union_busy"]

SLICE = "pb.slice"


def _t(e) -> tuple[int, int]:
    """``(start, end)`` of a kineto event in ns."""
    if hasattr(e, "start_ns"):
        s = int(e.start_ns())
        return s, s + int(e.duration_ns())
    s = int(e.start_us()) * 1000
    return s, s + int(e.duration_us()) * 1000


def union_busy(iv: list[tuple[int, int]], lo: int, hi: int):
    """The union of intervals ``iv`` clipped to ``[lo, hi]``: ``(busy ns,
    gaps)``, each gap ``(start, end)``, in order."""
    busy, gaps = 0, []
    cur = lo
    for s, e in sorted(iv):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


class Trace:
    """One slice's device operations: ``ops`` as ``(name, start, end)``
    in ns, ``lo``/``hi`` its host interval, ``host`` the harness thread's
    host operations as ``(start, end, name)``."""

    def __init__(self, ops, lo, hi, host):
        self.ops, self.lo, self.hi, self.host = ops, lo, hi, host

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def kernels(self) -> list:
        """Device operations that are kernels (not copies or fills)."""
        return [o for o in self.ops
                if not o[0].startswith(("Memcpy", "Memset", "memcpy",
                                        "memset"))]

    def busy_gaps(self):
        return union_busy([(s, e) for _, s, e in self.ops], self.lo, self.hi)

    def busy_s(self) -> float:
        return self.busy_gaps()[0] / 1e9

    def time_by_name(self) -> dict:
        out: dict = defaultdict(int)
        for n, s, e in self.ops:
            out[n] += min(e, self.hi) - max(s, self.lo)
        return {n: t / 1e9 for n, t in out.items()}

    def device_s(self, match) -> float:
        """Seconds of the operations whose name ``match`` accepts."""
        return sum(t for n, t in self.time_by_name().items() if match(n))

    def idle_by_host(self) -> dict:
        """Idle seconds by the innermost host operation running at each
        gap's middle (``"(none)"`` where none ran)."""
        _, gaps = self.busy_gaps()
        mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
        host = sorted(self.host)
        out: dict = defaultdict(int)
        heap: list = []                     # (-start, end, name)
        j = 0
        for t, length in mids:
            while j < len(host) and host[j][0] <= t:
                s, e, n = host[j]
                heapq.heappush(heap, (-s, e, n))
                j += 1
            # the innermost running op: the latest-started one not ended
            # (an op that ended before t ended before every later t too)
            while heap and heap[0][1] <= t:
                heapq.heappop(heap)
            best = heap[0] if heap else None
            out[best[2] if best else "(none)"] += length
        return {n: v / 1e9 for n, v in out.items()}

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n, t] for n, t in ops[:top]],
                "idle_gaps": [[n, t] for n, t in gaps[:top]]}


def _annotation(e) -> bool:
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return True
    return e.name() == SLICE or e.name().startswith("sched.")


def reduce(prof) -> Trace:
    """The ``pb.slice`` of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    marks = [e for e in evs if e.name() == SLICE]
    if not marks:
        raise RuntimeError("the trace holds no pb.slice span")
    lo, hi = _t(marks[0])
    tid = marks[0].start_thread_id()
    ops, host = [], []
    for e in evs:
        s, t = _t(e)
        if e.device_type() == DeviceType.CUDA:
            # a host span with device work beneath it is mirrored on the
            # device as a user annotation: not an operation
            if _annotation(e):
                continue
            if t > lo and s < hi:
                ops.append((e.name(), s, t))
        elif (e.start_thread_id() == tid and e.name() != SLICE
              and t > lo and s < hi):
            host.append((s, t, e.name()))
    return Trace(ops, lo, hi, host)
