"""The system under test and the closed loop that drives it.

The server is built as ``repro_torch.launch.serve.build_server`` builds
it (``AdaptiveServer`` with an ``AdaptiveEngine`` over the paper's
profiles and a ``ProfileManager``), over the weights the benchmark made,
with the cell's rows, slots and energy regime. One
``ContinuousScheduler`` serves the whole run: the warm-up sweep, the ramp
and the window. A new scheduler would start a new graph lifetime, so the
warm-up runs on the one the window drives.

The loop speaks to the scheduler only through ``submit``, ``step`` and
``poll_completed`` (and reads ``results[rid]["tokens"]`` to see a first
token): one client per row sends its next request once
``poll_completed`` hands its last one back. Every step is a round; the
harness stamps each request's submission, its first token (the first
``step()`` after which its result holds a token) and its completion on
the host clock."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from pb_traffic import Req, Stream

__all__ = ["Record", "Round", "Served", "next_pow2"]


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@dataclasses.dataclass
class Record:
    """One request's life as the client saw it."""

    req: Req
    rid: int
    t_sub: float
    round_sub: int = 0                    # rounds run before its submission
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    round_first: Optional[int] = None     # the round that admitted it
    n_tok: int = 0
    tokens: Optional[list] = None
    trace: Optional[list] = None
    status: Optional[str] = None


@dataclasses.dataclass
class Round:
    """One ``step()`` of the window."""

    index: int
    t0: float
    t1: float
    tokens: int                  # tokens the clients received after it
    firsts: int                  # of which first tokens
    decode_steps: int            # the scheduler's decode steps in it
    wave: bool                   # whether an admission wave replayed
    admitted: list               # records whose first token it gave
    deltas: list                 # (record, tokens before, tokens after)


def model_config(m: dict):
    """The program's ``ModelConfig`` of configuration fields ``m``."""
    from repro_torch.models.moe import MoEConfig
    from repro_torch.models.transformer import ModelConfig
    kw = dict(m)
    moe = kw.pop("moe", None)
    if moe is not None:
        kw["moe"] = MoEConfig(**moe)
    return ModelConfig(**kw)


class Served:
    """The server and its one scheduler for a cell, over ``params``."""

    def __init__(self, cell, params: dict, device: torch.device):
        from repro_torch.core.engine import AdaptiveEngine, QuantIndex
        from repro_torch.core.manager import ProfileManager
        from repro_torch.core.profiles import paper_profiles
        from repro_torch.launch.serve import profile_stats
        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import (AdaptiveServer,
                                                ServingConfig,
                                                check_servable)
        from repro_torch.serving.scheduler import ContinuousScheduler
        conf, c = cell.config, cell.cell
        sv, mg = conf["serving"], conf["manager"]
        cfg = model_config(conf["model"])
        check_servable(cfg)
        names = T.quant_layer_names(cfg)
        profs = paper_profiles(names, inner_layers=[])
        if [p.name for p in profs] != list(mg["profiles"]):
            raise ValueError(f"the program's profiles "
                             f"{[p.name for p in profs]} are not the "
                             f"configuration's {mg['profiles']}")
        engine = AdaptiveEngine(tuple(profs), QuantIndex(names))
        stats = profile_stats(cfg, profs, T.param_count(params))
        budget = stats[0].energy_j * float(mg["budget_inferences"])
        mgr = ProfileManager(stats, accuracy_target=mg["accuracy_target"],
                             accuracy_floor=mg["accuracy_floor"],
                             budget_j=budget, low_energy=mg["low_energy"],
                             spent_j=budget * float(c["spent_share"]))
        backend = sv["paged_backend"] if device.type == "cuda" else "gather"
        scfg = ServingConfig(slots=int(c["slots"]), kv_bits=sv["kv_bits"],
                             max_batch=int(c["rows"]),
                             paged_kv=sv["paged_kv"],
                             block_size=sv["block_size"],
                             prefix_cache=sv["prefix_cache"],
                             paged_backend=backend)
        self.cfg = cfg
        self.manager = mgr
        self.srv = AdaptiveServer(cfg, params, engine, scfg, manager=mgr,
                                  device=device)
        self.sched = ContinuousScheduler(self.srv, quantum=sv["quantum"],
                                         record_events=False)
        self.device = device
        self.rows = int(c["rows"])
        self.rounds = 0

    # ------------------------------------------------------------ readings
    def captures(self) -> Optional[int]:
        s = self.sched
        if s.graphs is None:
            return None
        return len(s.graphs.captured) + len(s.waves.captured)

    def wave_replays(self) -> int:
        return self.sched.waves.replays if self.sched.waves is not None else 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- driving
    def request(self, r: Req):
        from repro_torch.serving.engine import Request
        return Request(tokens=r.prompt, max_new=r.max_new,
                       accuracy_critical=r.critical, priority=0)

    def step(self) -> None:
        self.sched.step()
        self.rounds += 1

    def sweep(self, mix: dict, seed: int) -> int:
        """Warm-up: every wave key the mix can reach, each used twice
        (its capture, then its first replay), at both profile ids the
        saver regime picks (all-critical waves and segments, then none
        critical). Returns the waves run."""
        lo = int(mix["prompt_tokens"]["lo"])
        hi = int(mix["prompt_tokens"]["hi"])
        buckets = []
        b = next_pow2(max(8, lo))
        while b <= next_pow2(max(8, hi)):
            buckets.append(b)
            b *= 2
        rows, a = [], 1
        while a <= self.rows:
            rows.append(a)
            a *= 2
        rng = np.random.default_rng((int(seed) + 1) % 2 ** 63)
        vocab = self.cfg.vocab
        n = 0
        for crit in (True, False):
            for a in rows:
                for b in buckets:
                    plen = max(lo, min(hi, b))
                    for _ in range(2):
                        for _ in range(a):
                            r = Req(-1, rng.integers(0, vocab, plen).astype(
                                np.int32), 2, crit)
                            self.sched.submit(self.request(r))
                        self.drain()
                        n += 1
        return n

    def drain(self, deadline: Optional[float] = None) -> list:
        """Step until the scheduler is idle (or past ``deadline``);
        returns what ``poll_completed`` handed back."""
        out = []
        while True:
            busy = self.sched.step()
            self.rounds += 1
            out += self.sched.poll_completed()
            if not busy or (deadline is not None
                            and time.perf_counter() > deadline):
                return out


class Loop:
    """The closed loop: ``clients`` clients, each with one request in
    flight, over one :class:`~pb_traffic.Stream`."""

    def __init__(self, served: Served, stream: Stream, clients: int):
        self.s = served
        self.stream = stream
        self.clients = clients
        self.live: dict[int, Record] = {}
        self.records: list[Record] = []
        self.submitting = True
        self.spans = False       # host spans around the calls (traced run)

    def _span(self, name: str):
        if self.spans:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _submit(self) -> None:
        r = self.stream.next()
        with self._span("sched.submit"):
            rid = self.s.sched.submit(self.s.request(r))
        rec = Record(r, rid, time.perf_counter(), self.s.rounds)
        self.live[rid] = rec
        self.records.append(rec)

    def start(self) -> None:
        for _ in range(self.clients):
            self._submit()

    def round(self) -> Round:
        s = self.s
        dsteps, replays = s.sched.decode_steps, s.wave_replays()
        t0 = time.perf_counter()
        with self._span("sched.step"):
            s.step()
        t1 = time.perf_counter()
        admitted, deltas = [], []

        def seen(rec: Record, n: int) -> None:
            if n and rec.t_first is None:
                rec.t_first, rec.round_first = t1, s.rounds
                admitted.append(rec)
            if n != rec.n_tok:
                deltas.append((rec, rec.n_tok, n))
                rec.n_tok = n

        results = s.sched.results
        for rid, rec in self.live.items():
            res = results.get(rid)
            if res is not None:
                seen(rec, len(res["tokens"]))
        with self._span("sched.poll_completed"):
            done = s.sched.poll_completed()
        for rid, res in done:
            rec = self.live.pop(rid)
            seen(rec, len(res["tokens"]))
            rec.t_done = t1
            rec.tokens = list(res["tokens"])
            rec.trace = list(res["profile_trace"])
            st = res.get("status")
            rec.status = getattr(st, "value", str(st))
        if self.submitting:
            for _ in range(len(done)):
                self._submit()
        return Round(s.rounds, t0, t1, sum(b - a for _, a, b in deltas),
                     len(admitted), s.sched.decode_steps - dsteps,
                     s.wave_replays() > replays, admitted, deltas)
