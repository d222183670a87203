"""Adaptive serving engine (port of ``repro/serving/engine.py``): static
grouped serving (``generate``, ``serve``, the per-token oracle
``generate_stepwise``) on a contiguous KV cache, and the continuous-batching
primitives on the paged pool and the contiguous pool. On CUDA the static
path's prefill, decode and stepwise step and the scheduler's segments and
waves replay CUDA graphs (:mod:`repro_torch.serving.graphs`), where the
reference runs a compiled executable.

The reference's jitted closures become methods that update the scheduler's
pool tensors in place (its donated carries). Profile adaptivity stays
bits-as-data: a profile id indexes the host bits table and the per-profile
weight images, so switching profiles loads nothing.

Prefills and decode steps run on the prequantized weight images rather than
on the float masters. That is the reference's arithmetic: fake-quant is
elementwise once its per-tensor scale is fixed, so quantizing the master
per call (the reference) and once up front (here) give the same values.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import AdaptiveEngine
from repro_torch.core.manager import ProfileManager
from repro_torch.models import transformer as T
from repro_torch.models.attention import _mapped
from repro_torch.serving.graphs import (Capture, SegmentGraphs,
                                        SpecSegmentGraphs, StaticGraphs,
                                        cuda_capture, graphable)
from repro_torch.runtime import resolve_device

__all__ = ["ServingConfig", "AdaptiveServer", "Request", "RequestStatus",
           "check_servable"]


class RequestStatus(str, enum.Enum):
    """Terminal outcome of one request (the reference's enum): every
    request the continuous scheduler accepts leaves through exactly one.
    ``COMPLETED`` — all tokens delivered; ``CANCELLED`` —
    :meth:`~repro_torch.serving.scheduler.ContinuousScheduler.cancel`;
    ``EXPIRED`` — ``Request.deadline_ms`` passed, or admission predicted it
    unreachable; ``SHED`` — a :class:`~repro_torch.serving.policy.
    ShedPolicy` judged the pool overloaded at submission; ``FAILED`` —
    quarantine retries exhausted."""

    COMPLETED = "completed"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    SHED = "shed"
    FAILED = "failed"


def _next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (shape-bucketing helper)."""
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Deployment knobs, the reference's fields one for one.

    ``slots`` — per-row KV capacity in tokens (must cover ``prompt_len +
    max_new``). ``kv_bits`` — KV storage: 16 (bf16), 8 (int8), 4 (packed
    int4) or 32 (f32, gather backend only). ``max_batch`` — decode rows:
    the static group width of :meth:`AdaptiveServer.serve` and the size of
    the scheduler's slot pool. ``greedy`` — argmax decoding, the
    reference's only mode (``False`` is refused). ``paged_kv`` — the
    scheduler's pool is a global block pool with per-row block tables;
    ``False`` keeps contiguous ``[max_batch, slots]`` rows (the static
    paths always decode on a contiguous cache); an SSM stack has no KV to
    page, and its scheduler keeps the contiguous pool of SSM state rows
    whatever ``paged_kv`` says. ``block_size`` — tokens per KV block.
    ``pool_blocks`` — physical blocks (``None``: ``max_batch ·
    ceil(slots / block_size)``, the contiguous footprint).

    ``paged_backend`` — the server's one kernel switch, resolved into
    :attr:`AdaptiveServer.paged_backend`: ``"kernel"`` attends in place
    through the paged-attention kernel on a paged pool and reads a
    contiguous kv8 cache through the int8-KV decode kernel (K4);
    ``"gather"`` builds the per-segment dense view of a paged pool and
    reads a contiguous kv8 cache through the reference's einsum;
    ``"auto"`` is the kernel on CUDA and gather on the CPU; ``"pallas"``
    (the reference's name for its kernel) is ``"kernel"``. Contiguous kv16
    and kv4 caches have no kernel, in the reference either: they run the
    reference's ``decode_attention`` on every backend. On the kernel
    backend (``"kernel"``, or ``"auto"`` on CUDA) the server checks at
    construction that each kernel it will launch takes the model's shapes
    — K1 on a paged pool (D even, ``<= 256``; any block size and Hg), K2
    when ``speculate`` on a paged pool (the same, any ``draft_k``), K4 at
    kv8 (D a multiple of 4, ``<= 256``, Hg ``<= 16``) — and raises a
    ``ValueError`` naming ``paged_backend="gather"`` otherwise; it never
    switches backend by itself. The check runs on every device, so the CPU
    sees the same refusal as the card.

    Speculative decoding: ``speculate`` decodes through draft/verify
    windows — each segment window proposes ``draft_k`` tokens per row and
    verifies the ``draft_k + 1`` window in one batched forward
    (:func:`repro_torch.models.transformer.decode_segment_spec`),
    delivering 1..``draft_k + 1`` tokens per row, the same tokens as greedy
    decode. Needs a ``supports_speculation`` stack (full causal attention,
    kv16/kv8), on the paged or the contiguous pool. ``draft_hist`` is the
    token history the n-gram drafter sees. ``draft_model``:
    ``None``/``"ngram"`` = the n-gram drafter, ``"repeat"`` = repeat the
    current token; a small-model drafter plugs in as
    :class:`AdaptiveServer`'s ``draft_fn``.

    Shared prefixes and chunked prefill (paged pool, full causal attention
    only): ``prefix_cache`` — register block-aligned prompt prefixes and
    serve hash-matched admissions from them: a hit prefills only the
    suffix and (at kv16) maps the registered blocks copy-on-write instead
    of re-storing them. ``prefix_capacity`` bounds the registered entries
    (LRU; one prompt registers its whole block-aligned prefix chain, one
    entry per length, so later prompts match at any block boundary).
    ``prefill_chunk`` — admission prompts longer than this many tokens
    prefill in block-aligned chunks (rounded down to a block multiple, at
    least one block) that interleave with decode segments instead of one
    monolithic wave; ``None`` disables chunking. ``kv16_masters`` — keep
    f32 KV masters for shared prefixes and chunked rows at ``kv_bits=16``
    too, so every continuation replays the prefix from the raw
    activations where it would otherwise gather the bf16 blocks (int
    pools always keep masters; other precisions are refused).

    Priority classes and preemption (the continuous scheduler's policy,
    :func:`~repro_torch.serving.policy.make_policy`):
    ``priority_classes`` — 1 is the classless FIFO; ``n >= 2`` builds the
    critical/…/saver ladder, where class 0 admits first and binds its rows'
    waves and steps to the accuracy target. ``preemption`` — a critical
    arrival that cannot admit evicts saver-class rows, which later resume
    bit-exactly through the master-replay continuation wave
    (:meth:`AdaptiveServer.wave` ``"master"`` with an empty suffix); needs
    the paged pool on a ``supports_prefix_sharing`` stack. ``aging`` —
    rounds a queued request waits at the head of its class before it
    climbs one level (``None``: strict lowest-level-first).

    ``precision_policy`` — the per-layer KV precision policy: a
    ``[n_profiles, n_layers]`` nested tuple of bit-widths in (4, 8, 16),
    typically the row :meth:`~repro_torch.core.manager.ProfileManager.
    search_precision` found (``python -m repro_torch.launch.
    precision_frontier``). Each profile binds its row; at 8 or 4 bits the
    fresh K/V of that layer are fake-quantized
    (:func:`~repro_torch.models.attention.kv_refine`) wherever they are
    born, and 16 is an exact passthrough, so an all-16 row for the
    accuracy-critical profile keeps its tokens those of no policy. The
    pool stays at ``kv_bits``. ``None`` (default) runs the policy-free ops.
    Incompatible with ``speculate`` (the verify windows take no row).
    """

    slots: int = 4096
    kv_bits: int = 16
    max_batch: int = 8
    greedy: bool = True
    paged_kv: bool = True
    block_size: int = 16
    pool_blocks: Optional[int] = None
    prefix_cache: bool = True
    prefix_capacity: int = 32
    paged_backend: str = "auto"
    prefill_chunk: Optional[int] = None
    priority_classes: int = 1
    preemption: bool = False
    aging: Optional[int] = None
    speculate: bool = False
    draft_k: int = 4
    draft_hist: int = 32
    draft_model: Optional[str] = None
    kv16_masters: bool = False
    precision_policy: Optional[tuple] = None


@dataclasses.dataclass
class Request:
    """One generation request: a ``[S]`` int32 prompt, a token budget, and
    the paper's accuracy-critical flag. ``priority`` is the class index
    under a class-aware policy (0 = most urgent, clamped into the ladder;
    the FIFO ignores it). ``deadline_ms`` is a completion deadline in
    milliseconds from submission (``None``: none): the continuous scheduler
    finalizes a request past it ``EXPIRED`` (a live row is reaped at the
    next flush boundary with the tokens it generated) and rejects one at
    admission whose deadline its step-time estimate rules unreachable."""

    tokens: np.ndarray
    max_new: int = 32
    accuracy_critical: bool = False
    priority: int = 1
    deadline_ms: Optional[float] = None


def check_servable(cfg: T.ModelConfig) -> None:
    """Refuse a stack the server cannot feed: requests carry token
    prompts only, so an encoder-only stack (no decode step) and a stack
    with a vision or audio frontend (whose forward needs ``patch_embeds``
    or ``features``) raise ``ValueError``. The reference's server takes
    the same requests and fails on such a stack's first prefill with a
    ``KeyError``."""
    if not cfg.causal:
        raise ValueError("encoder-only arch has no decode step")
    if cfg.frontend:
        need = "patch_embeds" if cfg.frontend == "vision" else "features"
        raise ValueError(
            f"{cfg.name}: the server takes token prompts only, and its "
            f"{cfg.frontend} frontend needs {need!r} in every batch (the "
            f"reference's server fails on its first prefill with "
            f"KeyError: {need!r})")


# the static path's graph buffers: a group's ``max_new − 1`` decode steps
# replay in chunks of this many
STATIC_STEPS = 32


def _put_rows(dst: torch.Tensor, sidx: torch.Tensor, src: torch.Tensor,
              dim: int = 1) -> None:
    """``dst``'s row ``sidx[j]`` along ``dim`` becomes ``src``'s row ``j``
    for every ``j`` with ``0 <= sidx[j] < dst.shape[dim]``; the other rows
    of ``src`` write nothing (the reference's ``mode="drop"``). Fixed
    shapes, no host index set: a dropped row repeats the first live row's
    write (same row, same values), so the duplicate indices agree; with no
    live row every write puts a row of ``dst`` back as it was."""
    n = dst.shape[dim]
    live = (sidx >= 0) & (sidx < n)
    first = torch.argmax(live.to(torch.int32))
    j = torch.where(live, torch.arange(sidx.shape[0], device=sidx.device),
                    first)
    t = sidx.long().index_select(0, j).clamp(0, n - 1)
    vals = torch.where(live.any(), src.index_select(dim, j).to(dst.dtype),
                       dst.index_select(dim, t))
    dst.index_copy_(dim, t, vals)


def _put_cache_rows(pool, rows, sidx: torch.Tensor) -> None:
    """:func:`_put_rows` of every tensor field of the stacked cache ``rows``
    (``[L, a, ...]``) over ``pool`` (``[L, B, ...]``): wave rows land whole
    at pool rows ``sidx``."""
    for f in dataclasses.fields(pool):
        x = getattr(pool, f.name)
        if isinstance(x, torch.Tensor):
            _put_rows(x, sidx, getattr(rows, f.name))


class AdaptiveServer:
    """Serving entry points over one model: static grouped serving
    (:meth:`generate`, :meth:`serve`, :meth:`generate_stepwise`) and the
    continuous-batching primitives (admission waves into the paged or the
    contiguous pool, decode segments, row clearing) shared by every
    :class:`~repro_torch.serving.scheduler.ContinuousScheduler` built on it,
    over the per-profile weight images.

    Args:
        cfg: model architecture.
        params: parameter tree on ``device`` (fixed for the server's life).
        engine: merged :class:`AdaptiveEngine` (profiles + bits table).
        serving: :class:`ServingConfig`.
        manager: optional :class:`ProfileManager`; ``None`` pins profile 0.
        device: where the server runs — CUDA unless ``"cpu"`` is asked for.
        draft_fn: optional drafter ``(hist [B, Hn], tok [B]) -> [B,
            draft_k]`` for a speculative server (e.g. a small model);
            ``None`` defers to ``ServingConfig.draft_model``.
    """

    def __init__(self, cfg: T.ModelConfig, params: dict,
                 engine: AdaptiveEngine, serving: ServingConfig,
                 manager: Optional[ProfileManager] = None, device=None,
                 draft_fn=None):
        check_servable(cfg)
        self.cfg = cfg
        self.params = params
        self.engine = engine
        self.scfg = serving
        self.manager = manager
        self.device = resolve_device(device)
        pdev = params["norm_f"]["g"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, server runs on "
                             f"{self.device}")
        if serving.kv_bits not in (4, 8, 16, 32):
            raise ValueError(f"kv_bits must be 4, 8, 16 or 32, "
                             f"got {serving.kv_bits}")
        if serving.kv16_masters and serving.kv_bits != 16:
            raise ValueError(
                "kv16_masters only applies to bf16 pools (kv_bits=16): "
                f"a kv{serving.kv_bits} pool is lossy and always keeps "
                "full-precision masters")
        if not serving.greedy:
            raise ValueError("greedy=False: greedy decoding is the only "
                             "mode, as in the reference")
        pb = serving.paged_backend
        if pb not in ("auto", "kernel", "pallas", "gather"):
            raise ValueError(f"paged_backend must be auto|kernel|pallas|"
                             f"gather, got {pb!r}")
        if pb == "pallas":               # the reference's name for it
            pb = "kernel"
        has_kernel = serving.kv_bits in (4, 8, 16)
        if pb == "auto":
            pb = "kernel" if self.device.type == "cuda" and has_kernel \
                else "gather"
        if pb == "kernel" and not has_kernel:
            raise ValueError(f"the paged-attention kernel has no kv"
                             f"{serving.kv_bits} path (kv4/kv8/kv16 only)")
        if serving.speculate:
            if not T.supports_speculation(cfg, serving.kv_bits):
                raise ValueError(
                    "speculate=True needs a supports_speculation stack: "
                    "full causal attention (no SSM/MoE/sliding-window) "
                    "with kv_bits in (8, 16)")
            if serving.draft_k < 1:
                raise ValueError("draft_k must be >= 1")
            if serving.draft_hist < 2:
                raise ValueError("draft_hist must be >= 2 (the n-gram "
                                 "drafter matches history pairs)")
        if draft_fn is None:
            if serving.draft_model in (None, "ngram"):
                pass                     # decode_segment_spec's built-in
            elif serving.draft_model == "repeat":
                k = serving.draft_k

                def draft_fn(hist, tok):
                    return tok[:, None].expand(tok.shape[0], k)
            else:
                raise ValueError(f"unknown draft_model "
                                 f"{serving.draft_model!r}: use None, "
                                 f"'ngram' or 'repeat' (or pass draft_fn)")
        self.draft_fn = draft_fn
        # the precision policy's [P, L] table (host ints): a profile's row
        # reaches every model call it makes
        self.kv_table: Optional[np.ndarray] = None
        if serving.precision_policy is not None:
            if serving.speculate:
                raise ValueError(
                    "precision_policy is incompatible with speculate=True: "
                    "draft/verify windows do not thread the per-layer KV "
                    "schedule")
            pol = np.asarray(serving.precision_policy, np.int32)
            n_prof = len(engine.profile_names)
            if pol.shape != (n_prof, cfg.n_layers):
                raise ValueError(
                    f"precision_policy must have shape [n_profiles="
                    f"{n_prof}, n_layers={cfg.n_layers}], got "
                    f"{tuple(pol.shape)}")
            if not np.isin(pol, (4, 8, 16)).all():
                raise ValueError(
                    "precision_policy entries must be 4, 8 or 16")
            self.kv_table = pol
        # a preempted row resumes through the master-replay continuation
        # wave ("master", empty suffix) at every precision: its blocks
        # are gone, so the kv16 pool-gather wave cannot serve it
        self.can_restore = bool(serving.paged_kv
                                and T.supports_prefix_sharing(cfg))
        if serving.preemption and not self.can_restore:
            raise ValueError(
                "preemption requires the paged KV pool on a full-causal "
                "attention stack (supports_prefix_sharing): suspended rows "
                "resume through the continuation-prefill wave")
        self.paged_backend = pb
        self.block_size = T.paged_block_size(cfg, serving.slots,
                                             serving.block_size)
        if pb == "kernel":
            self._check_kernels()
        # a sliding-window row holds only its window (the block size
        # divides it, so the paged ring places tokens as the contiguous one)
        self.n_lblk = -(-T.eff_slots(cfg, serving.slots) // self.block_size)
        self.slots_p = self.n_lblk * self.block_size     # virtual row length
        # continuations (shared admissions, chunks) run prefill_extend at
        # absolute positions, exact only where prefix sharing is; a chunk
        # is a whole number of blocks, so the kv16 path can gather a
        # row's processed prefix straight from its own blocks
        can_share = T.supports_prefix_sharing(cfg)
        self.prefix_sharing = bool(serving.prefix_cache and can_share)
        self.chunk_tokens: Optional[int] = None
        if serving.prefill_chunk and can_share:
            self.chunk_tokens = max(
                self.block_size,
                int(serving.prefill_chunk) // self.block_size
                * self.block_size)
        # a bf16 pool is its own master (kv16 continuations gather the
        # prefix from the blocks); int pools, and kv16 with kv16_masters,
        # replay full-precision masters kept from the prefill
        self.masters_mode = (serving.kv_bits != 16
                             or bool(serving.kv16_masters))
        self._collect_masters = self.masters_mode and bool(
            self.prefix_sharing or self.chunk_tokens)
        # per-profile weight images, built once per server
        self.prequant = T.prequant_decode_weights(params, cfg, engine.table)
        # the static path's graphs, one StaticGraphs per group shape (rows,
        # slots, kv bits) with the contiguous cache it keeps, as
        # (graphs, kept cache), for the server's life
        self.static_graphs: dict = {}

    def _check_kernels(self) -> None:
        """Raise now, not at the first decode, if a kernel this server will
        launch cannot take the model's shapes: K1 on a paged pool, K2 when
        speculating on it, K4 at kv8 (static serving and the contiguous
        pool read an int8 cache through it). A stack without attention
        launches none of them. K3 needs no check: it masks ragged M, K and N
        itself, so it takes every native linear (the MoE stack's ``router``
        at N 60 and ``shared_*`` included), and ``to_native`` already
        refuses the one layout it cannot hold, packed int4 at an odd N. The
        routed stacks never reach it (they are dequantized, then
        multiplied)."""
        from repro_torch.kernels import paged_attention as PA
        from repro_torch.kernels import qkv_attention as QK
        cfg, scfg = self.cfg, self.scfg
        if not cfg.has_attn:
            return
        hg, d = cfg.n_heads // cfg.n_kv, cfg.hd
        checks = []
        if scfg.paged_kv:
            checks.append(("the paged-attention kernel (K1)",
                           PA.supports(d, hg, self.block_size)))
        if scfg.speculate and scfg.paged_kv:
            checks.append(("the window kernel (K2)",
                           PA.supports(d, hg, self.block_size,
                                       scfg.draft_k + 1)))
        if scfg.kv_bits == 8:
            checks.append(("the int8-KV decode kernel (K4)",
                           QK.supports(d, hg)))
        for name, why in checks:
            if why is not None:
                raise ValueError(
                    f"{name} cannot take {cfg.name}: {why}; serve it with "
                    f"paged_backend='gather' (--paged-backend gather)")

    def profile_params(self, pid: int) -> dict:
        """``params`` with profile ``pid``'s weight images grafted on."""
        return T.overlay_params(self.params, self.prequant[int(pid)])

    def kv_sched(self, pid: int) -> Optional[np.ndarray]:
        """Profile ``pid``'s row of the precision policy (``None``: no
        policy)."""
        return None if self.kv_table is None else self.kv_table[int(pid)]

    def _select_profile(self, critical: bool) -> int:
        if self.manager is None:
            return 0
        return self.manager.select(accuracy_critical=critical)

    def _prefill(self, pid: int, prompts: np.ndarray, slots: int,
                 prompt_len: Optional[np.ndarray] = None,
                 return_raw_kv: bool = False, into: Optional[dict] = None):
        """Ragged prefill of ``prompts [B, S]`` under profile ``pid`` into a
        contiguous ``[B, slots]`` cache (new, or ``into``) → ``(logits [B,
        V], caches)``, and the raw K/V with ``return_raw_kv``.
        ``prompts``/``prompt_len`` are host ints or int tensors on the
        device."""
        batch = {"tokens": T._ints(prompts, torch.int32, self.device)}
        if prompt_len is not None:
            batch["prompt_len"] = prompt_len
        return T.prefill(self.profile_params(pid), self.cfg,
                         self.engine.table[int(pid)], batch, slots,
                         kv_bits=self.scfg.kv_bits,
                         return_raw_kv=return_raw_kv,
                         kv_sched=self.kv_sched(pid), into=into)

    def _use_graphs(self, graphs: Optional[bool],
                    capture: Optional[Capture]) -> bool:
        """The static path's route: graphs by default on a CUDA server, or
        when a ``capture`` is given."""
        if graphs is None:
            return capture is not None or self.device.type == "cuda"
        return bool(graphs)

    # ----------------------------------------------------------- static path
    def generate(self, prompts: np.ndarray, max_new: int,
                 accuracy_critical: bool = False, *,
                 row_budget: Optional[np.ndarray] = None,
                 prompt_len: Optional[np.ndarray] = None,
                 row_critical: Optional[np.ndarray] = None,
                 account_rows: Optional[int] = None,
                 graphs: Optional[bool] = None,
                 capture: Optional[Capture] = None) -> dict:
        """Batched greedy generation: one prefill, then
        :meth:`decode_static` on the contiguous cache with the server's
        backend. prompts ``[B, S]``
        int32 (ragged requests left-padded to a common length, real lengths
        in ``prompt_len [B]``: per-row rope offsets, pad-key masks,
        logical-position KV handoff and ``pos0 = prompt_len``).
        ``row_budget [B]`` masks a row's tokens at index ≥ budget to −1.
        With a manager, per-row data (``row_budget`` / ``row_critical``)
        plans the schedule on the exact ragged ledger (step ``i`` bills
        only rows still live); otherwise ``account_rows`` rows (default
        ``B``) are billed every step. Returns the tokens and the per-step
        profile trace.

        ``graphs`` (default: on for a CUDA server, or when ``capture`` is
        given) runs the group on the
        :class:`~repro_torch.serving.graphs.StaticGraphs` of its shape
        ``(rows, slots, kv bits)``: the prefill replays the graph of its
        exact key (profile id, rows, ``S``, and whether ``prompt_len`` is
        given), captured on the key's first use and writing the shape's
        kept cache whole, then :meth:`decode_static` replays the decode over
        that cache. ``graphs=False`` runs the prefill and ``decode_many``
        eagerly; ``capture`` replaces the CUDA capture (tests). On the CPU
        ``graphs=True`` without a ``capture`` raises."""
        b, s = prompts.shape
        if self.manager is None:
            schedule = np.zeros((max_new,), np.int32)
        elif row_budget is not None or row_critical is not None:
            rb_plan = (np.full((b,), max_new) if row_budget is None
                       else np.minimum(np.asarray(row_budget), max_new))
            rc = (np.full((b,), bool(accuracy_critical))
                  if row_critical is None else np.asarray(row_critical, bool))
            schedule = self.manager.plan_schedule_ragged(max_new, rb_plan, rc)
        else:
            n_account = b if account_rows is None else account_rows
            schedule = self.manager.plan_schedule(
                max_new, n_account, accuracy_critical=accuracy_critical)
        rb = (np.full((b,), max_new, np.int32) if row_budget is None
              else np.asarray(row_budget, np.int32))
        if self._use_graphs(graphs, capture):
            g = self._static_set(b, capture)
            tok0 = g.prefill_group(int(schedule[0]), prompts, prompt_len)
            toks = self.decode_static(schedule, tok0, g.buf["pos"], g.kept,
                                      rb, graphs=True, capture=capture)
        else:
            logits, caches = self._prefill(int(schedule[0]), prompts,
                                           self.scfg.slots, prompt_len)
            pos0 = torch.as_tensor(
                np.full((b,), s, np.int32) if prompt_len is None
                else np.asarray(prompt_len, np.int32), device=self.device)
            toks = self.decode_static(schedule, logits, pos0, caches, rb,
                                      graphs=False)
        names = self.engine.profile_names
        # repro: allow(host-sync) the call's single decode sync, at the end
        return {"tokens": toks.cpu().tolist(),
                "profile_trace": [names[int(p)] for p in schedule]}

    def decode_static(self, schedule: np.ndarray, first: torch.Tensor,
                      pos0: torch.Tensor, caches: dict,
                      row_budget: np.ndarray, *,
                      graphs: Optional[bool] = None,
                      capture: Optional[Capture] = None) -> torch.Tensor:
        """:meth:`generate`'s decode after the prefill: the tokens ``[B,
        len(schedule)]`` of
        :func:`~repro_torch.models.transformer.decode_many`, bitwise.

        ``graphs=False`` runs ``decode_many`` eagerly from the prefill's
        logits ``first [B, V]`` and ``caches``. On graphs (the default as
        in :meth:`generate`) ``first`` is the prefill graph's first tokens
        ``[B]`` and ``caches`` the kept cache that graph wrote, of the
        group shape's :class:`~repro_torch.serving.graphs.StaticGraphs`:
        the decode steps replay one graph per profile id over it, captured
        on the id's first use; rebinding the server's images, backend or
        policy starts a new lifetime. On the CPU ``graphs=True`` without a
        ``capture`` raises."""
        if not self._use_graphs(graphs, capture):
            toks, _, _ = T.decode_many(
                self.params, self.cfg, self.engine.table, schedule, first,
                pos0, caches, row_budget=row_budget, prequant=self.prequant,
                paged_backend=self.paged_backend, kv_table=self.kv_table)
            return toks
        schedule = np.asarray(schedule, np.int32).reshape(-1)
        g = self._static_set(first.shape[0], capture)
        if caches is not g.kept:
            raise ValueError("the static decode's graphs replay over the "
                             "kept cache of the group shape, which its "
                             "prefill graph writes")
        g.stage(first, pos0, caches, np.asarray(row_budget, np.int32) - 1)
        live0 = g.buf["rem"] >= 0                # budget > 0, on the device
        g.buf["tok"].copy_(torch.where(live0, first, 0))
        ys = g.replay(schedule[1:], caches)[0]
        return torch.cat([torch.where(live0, first, -1)[:, None], ys], dim=1)

    def _static_set(self, rows: int,
                    capture: Optional[Capture]) -> StaticGraphs:
        """The :class:`~repro_torch.serving.graphs.StaticGraphs` of a group
        of ``rows`` rows, made on first use (and again for another
        ``capture``)."""
        key = (rows, self.scfg.slots, self.scfg.kv_bits)
        got = self.static_graphs.get(key)
        if got is not None and got[0]._capture is (capture or cuda_capture):
            return got[0]
        g = StaticGraphs(self, rows, STATIC_STEPS, capture=capture)
        self.static_graphs[key] = (g, g.kept)
        return g

    def generate_stepwise(self, prompts: np.ndarray, max_new: int,  # repro: allow(host-sync) seed oracle syncs per token by design
                          accuracy_critical: bool = False, *,
                          graphs: Optional[bool] = None,
                          capture: Optional[Capture] = None) -> dict:
        """The reference's per-token host loop (one decode step and one
        host argmax per token), kept as :meth:`generate`'s oracle: the
        profile is selected and billed (``B`` inferences) before the
        prefill and before every step. On graphs (the default as in
        :meth:`generate`) the prefill replays the uniform key's graph into
        the kept cache of the ``(B, slots, kv bits)`` group shape, and
        each step replays that shape's step graph of its profile id
        (:class:`~repro_torch.serving.graphs.StepGraphs`), the host
        reading its logits; ``graphs=False`` runs both eagerly."""
        b, s = prompts.shape
        names = self.engine.profile_names
        graphed = self._use_graphs(graphs, capture)
        pid = self._select_profile(accuracy_critical)
        if graphed:
            g = self._static_set(b, capture)
            nxt = g.prefill_group(pid, prompts).cpu().numpy()
        else:
            logits, caches = self._prefill(pid, prompts, self.scfg.slots)
            nxt = logits.float().cpu().numpy().argmax(axis=-1).astype(
                np.int32)
        if self.manager is not None:
            self.manager.account(pid, b)    # prefill billed like an inference
        out, trace = [nxt], [names[pid]]
        for step in range(max_new - 1):
            pid = self._select_profile(accuracy_critical)
            if graphed:
                logits = g.steps.run(pid, nxt[:, None],
                                     np.full((b,), s + step, np.int32),
                                     g.kept)
            else:
                pos = torch.full((b,), s + step, dtype=torch.int32,
                                 device=self.device)
                tok = torch.as_tensor(nxt[:, None], device=self.device)
                logits, caches = T.decode_step(
                    self.profile_params(pid), self.cfg,
                    self.engine.table[pid], tok, pos, caches,
                    paged_backend=self.paged_backend,
                    kv_sched=self.kv_sched(pid))
            if self.manager is not None:
                self.manager.account(pid, b)
            nxt = logits.float().cpu().numpy().argmax(axis=-1).astype(np.int32)
            out.append(nxt)
            trace.append(names[pid])
        return {"tokens": np.stack(out, axis=1).tolist(),
                "profile_trace": trace}

    def serve(self, requests: Sequence[Request], *,
              graphs: Optional[bool] = None,
              capture: Optional[Capture] = None) -> list[dict]:
        """Static request batching: sort by prompt length, cut into groups
        of up to ``max_batch``, one ragged :meth:`generate` per group.
        Prompts are left-padded with per-row ``prompt_len``, so every row
        emits what it would solo; groups are padded to ``max_batch`` rows
        (pad rows: budget 0, ``prompt_len`` 0, fully masked). Each result's
        ``profile_trace`` is cut to its own ``max_new``; the ledger bills
        per step only the rows still live. MoE groups are padded to the
        next power of two of at least 2 rows instead, as in the reference:
        pad rows are dropped from the capacity dispatch, and the group's
        ``rows · maxlen`` tokens must divide the MoE ``groups`` (a
        ``ValueError`` from :func:`~repro_torch.models.moe.moe_ffn`
        otherwise, where the reference asserts). ``graphs``/``capture``:
        see :meth:`generate` (one graph set per group shape, so MoE's row
        buckets bound the sets, and one prefill graph per exact key)."""
        results: list = [None] * len(requests)
        order = sorted(range(len(requests)),
                       key=lambda i: len(requests[i].tokens))
        for i0 in range(0, len(order), self.scfg.max_batch):
            group = order[i0:i0 + self.scfg.max_batch]
            maxlen = max(len(requests[i].tokens) for i in group)
            rows = (_next_pow2(max(2, len(group))) if self.cfg.family == "moe"
                    else self.scfg.max_batch)
            prompts = np.zeros((rows, maxlen), np.int32)
            budget = np.zeros((rows,), np.int32)
            plen = np.zeros((rows,), np.int32)       # pad rows: fully masked
            crit = np.zeros((rows,), bool)
            for row, i in enumerate(group):
                t = requests[i].tokens
                prompts[row, maxlen - len(t):] = t   # left-pad
                budget[row] = requests[i].max_new
                plen[row] = len(t)
                crit[row] = requests[i].accuracy_critical
            max_new = max(requests[i].max_new for i in group)
            out = self.generate(prompts, max_new, row_budget=budget,
                                prompt_len=plen, row_critical=crit,
                                graphs=graphs, capture=capture)
            for row, i in enumerate(group):
                mn = requests[i].max_new
                results[i] = {"tokens": out["tokens"][row][:mn],
                              "profile_trace": out["profile_trace"][:mn]}
        return results

    # ------------------------------------------------------ continuous path
    def wave(self, kind: str, pid: int, plan: dict, tok: torch.Tensor,
             pos: torch.Tensor, caches: dict, prefix: Optional[tuple] = None):
        """One admission wave in fixed shapes (the reference's ``admit_fn``,
        ``admit_paged_fn``, ``admit_shared_pool_fn`` and its master-replay
        body): the body :class:`~repro_torch.serving.graphs.WaveGraphs`
        captures, and the eager wave. ``plan`` holds the wave's int arrays
        (host ints, or int tensors on the device, which are read there):
        ``prompts [a, bucket]`` left-padded, ``plen [a]`` their lengths,
        ``sidx [a]`` the pool rows (out of range: padding, which writes
        nothing), and per ``kind``:

        - ``"cold"``: a ragged prefill into ``[a, slots]`` rows, each
          written whole over its pool row of the contiguous pool (a retired
          request's stale ``token_idx`` entries, or its SSM state, must not
          survive);
        - ``"paged"``: a ragged prefill into transient dense rows cut into
          blocks and scattered at physical blocks ``dest [a, n_lblk]``
          (entries outside the pool go to the write sink);
        - ``"pool"`` / ``"master"``: a continuation prefill of the suffixes
          over ``pre_len [a]`` prefix tokens, gathered as f32 from the bf16
          pool's blocks ``pre_bids [a, Pp / bs]`` (entries outside the pool
          read as zeros) or replayed from ``prefix`` (``(prefix_k,
          prefix_v [L, a, Pp, Hkv, hd], k_amax, v_amax [L, a, Hkv] or
          None)``); then the block scatter with ``dest`` out of the pool on
          shared blocks (never written: the copy-on-write) and ``bt [a,
          n_lblk]`` installed as the rows' tables;
        - ``"static"`` / ``"uniform"``: the static path's prefill of a
          group (``prompts`` and ``plen``; a uniform batch ``prompts``
          alone) written whole into ``caches``, its group shape's kept
          cache, with ``tok``/``pos`` its first tokens and ``pos0``
          (:meth:`_prefill_kept`).

        A live row's scales (int KV), table, SSM state (a hybrid stack)
        and carries (``tok`` = its first token, ``pos`` = its token count)
        are written at its pool row. Updates ``tok``/``pos``/``caches`` in
        place and returns ``(tok0 [a], raw)``: ``raw`` is the wave's
        pre-quantization K/V when the server keeps masters (not on a
        contiguous-pool wave), else ``None``."""
        dev = self.device
        p = {k: T._ints(v, torch.int32, dev) for k, v in plan.items()}
        if kind in ("static", "uniform"):
            return self._prefill_kept(pid, p, tok, pos, caches)
        collect = self._collect_masters and kind != "cold"
        if kind in ("cold", "paged"):
            out = self._prefill(pid, p["prompts"], self.scfg.slots
                                if kind == "cold" else self.slots_p,
                                p["plen"], return_raw_kv=collect)
            row_len = p["plen"]
        else:
            if kind == "pool":
                prefix = self._pool_prefix(caches["kv"], p["pre_bids"])
            pk, pv, ka, va = prefix
            out = T.prefill_extend(
                self.profile_params(pid), self.cfg,
                self.engine.table[int(pid)],
                {"tokens": p["prompts"], "prompt_len": p["plen"]},
                self.slots_p, kv_bits=self.scfg.kv_bits, prefix_k=pk,
                prefix_v=pv, prefix_len=p["pre_len"], prefix_k_amax=ka,
                prefix_v_amax=va, return_raw_kv=collect,
                kv_sched=self.kv_sched(pid))
            row_len = p["pre_len"] + p["plen"]
        rows, sidx = out[1], p["sidx"]
        tok0 = out[0].argmax(dim=-1).to(torch.int32)
        if kind == "cold":
            for key in caches:                   # "kv" and/or "ssm"
                _put_cache_rows(caches[key], rows[key], sidx)
        else:
            self._scatter_blocks(caches["kv"], rows["kv"], p["dest"], sidx,
                                 p.get("bt"))
            if "ssm" in caches:
                _put_cache_rows(caches["ssm"], rows["ssm"], sidx)
        _put_rows(tok, sidx, tok0, dim=0)
        _put_rows(pos, sidx, row_len, dim=0)
        return tok0, (out[2] if collect else None)

    def _prefill_kept(self, pid: int, p: dict, tok: torch.Tensor,
                      pos: torch.Tensor, caches: dict) -> tuple:
        """The static path's prefill body: the group's prefill written into
        ``caches`` (its group shape's kept cache) whole, the first tokens
        into ``tok`` and ``pos0`` (``plen``, or ``S`` for a uniform batch)
        into ``pos``. Returns ``(tok0 [B], None)``."""
        logits, _ = self._prefill(pid, p["prompts"], self.scfg.slots,
                                  p.get("plen"), into=caches)
        tok0 = logits.argmax(dim=-1).to(torch.int32)
        tok.copy_(tok0)
        if "plen" in p:
            pos.copy_(p["plen"])
        else:
            pos.fill_(p["prompts"].shape[1])
        return tok0, None

    def _pool_prefix(self, pool, pre_bids: torch.Tensor) -> tuple:
        """A bf16 pool's prefix operands: the K/V of blocks ``pre_bids [a,
        Pp / bs]`` as f32 ``[L, a, Pp, Hkv, hd]`` (entries outside the
        pool read as zeros), no amaxes."""
        a, pb = pre_bids.shape
        ok, idx = _mapped(pre_bids, pool.n_blocks)

        def gather(x):                           # [L, nb + 1, bs, Hkv, hd]
            g = torch.where(ok[None, :, :, None, None, None],
                            x[:, idx].float(), 0.0)
            return g.reshape(x.shape[0], a, pb * x.shape[2], *x.shape[3:])

        return gather(pool.k), gather(pool.v), None, None

    def admit_paged(self, pid: int, prompts: np.ndarray,
                    prompt_len: np.ndarray, slots_idx: np.ndarray,
                    dest: np.ndarray, tok: torch.Tensor, pos: torch.Tensor,
                    caches: dict):
        """One eager paged admission wave (the reference's
        ``admit_paged_fn``): :meth:`wave` ``"paged"`` with host arrays.
        Returns ``(tok0 [a], raw)``."""
        return self.wave("paged", pid, {"prompts": prompts,
                                        "plen": prompt_len,
                                        "sidx": slots_idx, "dest": dest},
                         tok, pos, caches)

    def _scatter_blocks(self, pool, rows, dest: torch.Tensor,
                        sidx: torch.Tensor,
                        bt_rows: Optional[torch.Tensor] = None) -> None:
        """Cut each wave row of the stacked dense cache ``rows`` (``[L, a,
        slots_p, ...]``) into ``n_lblk`` blocks and write them at ``dest``;
        a block whose entry is outside the pool, or whose row is padding,
        lands in the write sink. Install the live rows' block tables and
        scales at pool rows ``sidx``. The table is ``bt_rows`` where given
        — it differs from ``dest`` exactly on shared blocks, which are
        mapped but not written — else ``dest``."""
        nlb, bs, L = self.n_lblk, self.block_size, self.cfg.n_layers
        a = dest.shape[0]
        live = (sidx >= 0) & (sidx < pool.block_table.shape[1])
        ok, dst = _mapped(dest, pool.n_blocks)
        dst = torch.where(ok & live[:, None], dst, pool.n_blocks).reshape(-1)
        for name in ("k", "v", "token_idx"):
            x = getattr(rows, name)
            getattr(pool, name).index_copy_(
                1, dst, x.reshape(L, a * nlb, bs, *x.shape[3:]))
        table = dest if bt_rows is None else bt_rows
        _put_rows(pool.block_table, sidx, table[None].expand(L, a, nlb))
        _put_rows(pool.k_scale, sidx, rows.k_scale)
        _put_rows(pool.v_scale, sidx, rows.v_scale)

    def segment(self, schedule: np.ndarray, tok: torch.Tensor,
                pos: torch.Tensor, caches: dict, remaining: np.ndarray,
                fault_step: Optional[np.ndarray] = None,
                graphs: Optional[SegmentGraphs] = None):
        """One decode segment over the pool (``decode_segment`` on the
        server's images and backend). ``fault_step [B]`` poisons a row's
        logits with NaN at that step (−1: never). With ``graphs`` (the
        pool lifetime's :class:`~repro_torch.serving.graphs.SegmentGraphs`)
        the steps replay from its CUDA graphs, unless the backend is the
        gather path of a paged pool, which runs eagerly. Returns
        ``(tokens, row_ok, tok, pos, caches)``."""
        if graphs is not None and graphable(self):
            return graphs.run(schedule, tok, pos, caches, remaining,
                              fault_step)
        fs = (None if fault_step is None else
              torch.as_tensor(fault_step, dtype=torch.int32,
                              device=self.device))
        return T.decode_segment(self.params, self.cfg, self.engine.table,
                                schedule, tok, pos, caches, remaining,
                                prequant=self.prequant,
                                paged_backend=self.paged_backend,
                                fault_step=fs, kv_table=self.kv_table)

    def segment_spec(self, schedule: np.ndarray, hist: np.ndarray,
                     spec_on: np.ndarray, tok: torch.Tensor,
                     pos: torch.Tensor, caches: dict, remaining: np.ndarray,
                     quota: np.ndarray,
                     fault_step: Optional[np.ndarray] = None,
                     graphs: Optional[SpecSegmentGraphs] = None):
        """One speculative segment over the pool: ``len(schedule)``
        draft/verify windows (``decode_segment_spec`` on the server's
        images, backend and drafter). ``hist``/``spec_on``/``quota`` are
        the host's per-row drafter history, opt-out mask and quantum in
        delivered tokens; ``fault_step [B]`` poisons a row's verify window
        at that index (−1: never). With ``graphs`` (the pool lifetime's
        :class:`~repro_torch.serving.graphs.SpecSegmentGraphs`) the windows
        replay from its CUDA graphs, unless the backend is the gather path
        of a paged pool, which runs eagerly. Returns ``(tokens, delivered,
        row_ok, tok, pos, caches)``."""
        if graphs is not None and graphable(self):
            return graphs.run(schedule, hist, spec_on, tok, pos, caches,
                              remaining, quota, fault_step)
        return T.decode_segment_spec(
            self.params, self.cfg, self.engine.table, schedule, tok, pos,
            caches, remaining, quota=quota,
            hist0=torch.as_tensor(hist, device=self.device),
            spec_on=torch.as_tensor(spec_on, device=self.device),
            prequant=self.prequant, paged_backend=self.paged_backend,
            fault_step=fault_step, draft_k=self.scfg.draft_k,
            draft_fn=self.draft_fn)

    def clear_rows(self, slots_idx, caches: dict) -> dict:
        """Unmap the block tables of pool rows ``slots_idx`` (retirement),
        so a retired row's residual writes land in the write sink. A cache
        without KV (the SSM stack) has nothing to unmap."""
        pool = caches.get("kv")
        if pool is None:
            return caches
        s = [int(x) for x in slots_idx if 0 <= int(x) < pool.block_table.shape[1]]
        if s:
            pool.block_table[:, torch.as_tensor(s, device=self.device)] = \
                pool.n_blocks
        return caches
