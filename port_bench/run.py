#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

  python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

A run builds the cell's server over weights made on the card from the
seed, warms every graph key the cell's traffic can reach on the one
scheduler the window drives, ramps the closed loop up, measures for
``--seconds``, drains, frees the program's state, and judges what the
window served against the plain reference (``pb_correct``). Its last line
on standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks``: every compared number beside its limit, last); the last
lines on standard error say the same. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones, read from a
profiler slice of the window. ``--calibrate N`` instead reads the
numbers a limit is set from, the program's and the fp8 control's with
the control's own verdict, on N traffic seeds (no result line).

It runs only on CUDA: without a card, or with fewer than the cell asks
for, it exits with 2 and prints no result; so it does, without
``BENCHMARK.json`` or the program beside it, and when a JAX module is
loaded once the window has closed (looked for last, after the reference
and the metric readers have run)."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]
# the program builds its kernels into the checkout (build/repro_torch);
# any extension or Triton cache goes beside them, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that prints no result."""


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole: ``repro_torch`` passes."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def card_lines() -> list:
    """The card's name, power limit and clocks, and whether its cumulative
    energy counter reads (NVML ``nvmlDeviceGetTotalEnergyConsumption``)."""
    out = []
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        out.append(f"card: {q.stdout.strip() or q.stderr.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        out.append(f"card: nvidia-smi failed: {e}")
    try:
        import ctypes
        nv = ctypes.CDLL("libnvidia-ml.so.1")
        h = ctypes.c_void_p()
        mj = ctypes.c_ulonglong()
        rc = [nv.nvmlInit_v2(),
              nv.nvmlDeviceGetHandleByIndex_v2(0, ctypes.byref(h))]
        rc.append(nv.nvmlDeviceGetTotalEnergyConsumption(h, ctypes.byref(mj)))
        nv.nvmlShutdown()
        out.append(f"energy counter: nvml return codes {rc}, "
                   f"{mj.value} mJ since the driver loaded"
                   if rc == [0, 0, 0] else
                   f"energy counter: unreadable, nvml return codes {rc}")
    except (OSError, AttributeError) as e:
        out.append(f"energy counter: unreadable ({e})")
    return out


def window_lines(rounds, records, in_window, t0, t_end) -> list:
    """Earlier lines: the window's rounds, its latency distribution, and
    the share of served tokens at each profile."""
    import numpy as np
    from collections import Counter

    from pb_serve import next_pow2
    ttft = [1e3 * (r.t_first - r.t_sub) for r in records
            if r.t_first is not None and t0 <= r.t_first <= t_end]
    tpot = [1e3 * (r.t_done - r.t_first) / (len(r.tokens) - 1)
            for r in in_window if len(r.tokens) > 1]
    q = (lambda v: [round(float(np.percentile(v, p)), 3)
                    for p in (50, 95, 100)] if v else [])
    prof = Counter(p for r in in_window for p in r.trace)
    n = sum(prof.values()) or 1
    waves = Counter(len(r.admitted) for r in rounds if r.admitted)
    waits = Counter(r.round_first - r.round_sub for r in records
                    if r.t_first is not None and t0 <= r.t_first <= t_end)
    walls = [1e3 * (r.t1 - r.t0) for r in rounds]
    tails = ([round(float(np.percentile(ttft, p)), 1)
              for p in (75, 90, 95, 97.5, 99)] if ttft else [])
    by_key: dict = {}
    for r in rounds:
        if r.admitted:
            key = (next_pow2(len(r.admitted)), next_pow2(
                max(8, max(len(x.req.prompt) for x in r.admitted))))
            by_key.setdefault(key, []).append(1e3 * (r.t1 - r.t0))
    keys = {f"{a}x{b}": [len(v), round(float(np.median(v)), 1)]
            for (a, b), v in sorted(by_key.items())}
    return [f"ttft ms at [75, 90, 95, 97.5, 99]: {tails}; rows per wave: "
            f"{dict(sorted(waves.items()))}; rounds to first token: "
            f"{dict(sorted(waits.items()))}; round wall ms [p50, p95, max]: "
            f"{q(walls)}",
            f"rounds with a wave by its rows x prompt bucket: [rounds, "
            f"median wall ms]: {keys}",
            f"window: {t_end - t0:.3f} s, {len(rounds)} rounds, "
            f"{sum(r.wave for r in rounds)} with a wave, "
            f"{sum(r.decode_steps for r in rounds)} decode steps, "
            f"{len(in_window)} requests completed",
            f"latency ms [p50, p95, max]: ttft {q(ttft)} over {len(ttft)}, "
            f"tpot {q(tpot)} over {len(tpot)}",
            "served tokens by profile: " + ", ".join(
                f"{k} {100 * v / n:.2f} %" for k, v in sorted(prof.items()))]


class Ctx:
    """What the metric readers (``metrics/<name>.py``) read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def setup(cell, seed: int, device, log=print):
    """Weights from ``seed``, the server and its scheduler, and the
    warm-up sweep → ``(params, served)``."""
    from pb_serve import Served
    from pb_weights import make_params
    params = make_params(cell.config["model"], seed, device)
    served = Served(cell, params, device)
    t = time.perf_counter()
    waves = served.sweep(cell.traffic, seed)
    served.sync()
    mem = ""
    if device.type == "cuda":
        import torch
        gib = 2 ** 30
        mem = (f"; {torch.cuda.memory_allocated(device) / gib:.2f} GiB "
               f"allocated, peak "
               f"{torch.cuda.max_memory_allocated(device) / gib:.2f}")
    log(f"warm-up: {waves} sweep waves in {time.perf_counter() - t:.3f} s, "
        f"{served.captures()} graphs captured{mem}")
    return params, served


def window(served, cell, seed: int, seconds: float, trace: bool) -> dict:
    """The ramp, then ``seconds`` of the closed loop on the traffic of
    ``seed`` (with ``trace``, a profiler slice of the cell's
    ``trace_rounds``), then the drain: at most a minute past the close
    for what is in flight. Returns the window's record."""
    import torch

    from pb_serve import Loop
    from pb_trace import SLICE
    from pb_traffic import Stream
    c = cell.cell
    loop = Loop(served, Stream(cell.traffic, cell.config["model"]["vocab"],
                               seed), served.rows)
    loop.start()
    for _ in range(int(c.get("ramp_rounds", 0))):
        loop.round()
    served.sync()
    w = {"caps0": served.captures(), "t0": time.perf_counter(),
         "rounds": [], "sliced": [], "prof": None, "profiler_s": 0.0}
    rounds, sliced = w["rounds"], w["sliced"]
    skip, count = (int(c["trace_rounds"]["skip"]),
                   int(c["trace_rounds"]["count"]))
    prof = mark = None
    while time.perf_counter() < w["t0"] + seconds or (
            prof is not None and len(sliced) < count):
        if trace and prof is None and len(rounds) == skip:
            from torch.profiler import ProfilerActivity, profile
            t = time.perf_counter()
            served.sync()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if served.device.type == "cuda"
                else [])
            prof = w["prof"] = profile(activities=acts)
            prof.start()
            loop.spans = True
            mark = torch.profiler.record_function(SLICE)
            mark.__enter__()
            w["profiler_s"] += time.perf_counter() - t
        r = loop.round()
        rounds.append(r)
        if mark is not None:
            sliced.append(r)
            if len(sliced) == count:
                t = time.perf_counter()
                served.sync()
                mark.__exit__(None, None, None)
                mark = None
                prof.stop()
                loop.spans = False
                w["profiler_s"] += time.perf_counter() - t
    served.sync()
    w["t_end"] = time.perf_counter()
    w["caps1"] = served.captures()
    loop.submitting = False
    while loop.live and time.perf_counter() < w["t_end"] + 60.0:
        loop.round()
    w["records"] = loop.records
    w["in_window"] = [r for r in loop.records if r.status == "completed"
                      and w["t0"] <= r.t_done <= w["t_end"]]
    return w


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """One run of ``cell`` on ``device``; returns the result object."""
    import torch

    import pb_spec
    from pb_correct import check
    from pb_trace import reduce

    conf, c = cell.config, cell.cell
    cuda = device.type == "cuda"
    params, served = setup(cell, seed, device, log)
    w = window(served, cell, seed, seconds, trace)
    t0, t_end = w["t0"], w["t_end"]
    setup_s = t0 - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    records = w["records"]
    failed = sum(r.status != "completed" for r in records)
    del served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    for line in window_lines(w["rounds"], records, w["in_window"], t0, t_end):
        log(line)
    t = time.perf_counter()
    verdict = check(cell, params, w["in_window"], records, seed)
    log(f"reference: {time.perf_counter() - t:.3f} s; "
        f"{json.dumps(verdict['info'])}")
    del params
    tr = reduce(w["prof"]) if w["prof"] is not None else None
    ctx = Ctx(cell=cell, model=conf["model"],
              kv_bits=conf["serving"]["kv_bits"],
              quantum=conf["serving"]["quantum"], rows=int(c["rows"]),
              t0=t0, t_end=t_end, window_s=t_end - t0,
              profiler_s=w["profiler_s"], setup_s=setup_s,
              records=records, rounds=w["rounds"], sliced=w["sliced"],
              trace=tr, peak_bytes=peak, captures=(w["caps0"], w["caps1"]))
    metrics = {}
    for m in pb_spec.metrics_for(cell.bench, cell.name, trace):
        v = pb_spec.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
    out = {"correct": verdict["correct"], "attempted": len(records),
           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = tr.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in verdict["numbers"].items()}
    # last, once the reference and every metric reader have run
    bad = forbidden_modules(sys.modules)
    if bad:
        raise Refused(f"modules of JAX or the JAX package are loaded: {bad}")
    return out


def calibrate(cell, seed: int, n: int, seconds: float, device,
              log=print) -> list:
    """The readings a limit is set from: one set-up from ``seed``, then
    ``n`` windows of ``seconds`` on the traffic of seeds ``seed + 1 ..
    seed + n``; once the program's state is freed, each window is judged,
    and so is the fp8 control in the program's place."""
    import torch

    from pb_correct import check
    params, served = setup(cell, seed, device, log)
    wins = []
    for i in range(1, n + 1):
        w = window(served, cell, seed + i, seconds, False)
        wins.append((seed + i, w["in_window"], w["records"]))
    del served, w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = []
    for s, in_window, records in wins:
        v = check(cell, params, in_window, records, s, control=True)
        ctl = v["control"]
        row = {"seed": s, "correct": v["correct"],
               "control_correct": ctl["correct"], **v["info"],
               **{k: x for k, (x, _) in v["numbers"].items()},
               **{f"control_{k}": x for k, (x, _) in ctl["numbers"].items()}}
        log(f"calibrate: {json.dumps(row)}")
        out.append(row)
    return out


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="read the program's and the fp8 control's numbers "
                         "on N traffic seeds after one set-up, and print "
                         "them (no result line)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        import torch

        import pb_spec
        cell = pb_spec.cell(args.workload)
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell asks for {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
        for line in card_lines():
            print(line, file=sys.stderr, flush=True)
        log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
        if args.calibrate:
            calibrate(cell, args.seed, args.calibrate, args.seconds,
                      torch.device("cuda", 0), log)
            return 0
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START, log=log)
    except (Refused, ImportError, FileNotFoundError, KeyError) as e:
        print(f"run.py: no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
