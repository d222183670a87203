"""Adaptive serving engine (port of ``repro/serving/engine.py``): static
grouped serving (``generate``, ``serve``, the per-token oracle
``generate_stepwise``) on a contiguous KV cache, and the continuous-batching
primitives on the paged pool and the contiguous pool.

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
    (:meth:`AdaptiveServer.admit_shared` with an empty suffix); needs the
    paged pool on a ``supports_prefix_sharing`` stack. ``aging`` — rounds
    a queued request waits at the head of its class before it climbs one
    level (``None``: strict lowest-level-first).

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


def _write_rows(pool, rows, s: torch.Tensor, j: torch.Tensor) -> None:
    """Write wave rows ``j`` of the stacked cache ``rows`` whole over pool
    rows ``s`` (every tensor field, ``[L, B, ...]``)."""
    for f in dataclasses.fields(pool):
        x = getattr(pool, f.name)
        if isinstance(x, torch.Tensor):
            x[:, s] = getattr(rows, f.name)[:, j]


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
        # wave (admit_shared, empty suffix) at every precision: its blocks
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
                 return_raw_kv: bool = False):
        """Ragged prefill of ``prompts [B, S]`` under profile ``pid`` into a
        contiguous ``[B, slots]`` cache → ``(logits [B, V], caches)``, and
        the raw K/V with ``return_raw_kv``."""
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=self.device)}
        if prompt_len is not None:
            batch["prompt_len"] = np.asarray(prompt_len, np.int32)
        return T.prefill(self.profile_params(pid), self.cfg,
                         self.engine.table[int(pid)], batch, slots,
                         kv_bits=self.scfg.kv_bits,
                         return_raw_kv=return_raw_kv,
                         kv_sched=self.kv_sched(pid))

    # ----------------------------------------------------------- static path
    def generate(self, prompts: np.ndarray, max_new: int,
                 accuracy_critical: bool = False, *,
                 row_budget: Optional[np.ndarray] = None,
                 prompt_len: Optional[np.ndarray] = None,
                 row_critical: Optional[np.ndarray] = None,
                 account_rows: Optional[int] = None) -> dict:
        """Batched greedy generation: one prefill, then
        :func:`~repro_torch.models.transformer.decode_many` on the
        contiguous cache with the server's backend. prompts ``[B, S]``
        int32 (ragged requests left-padded to a common length, real lengths
        in ``prompt_len [B]``: per-row rope offsets, pad-key masks,
        logical-position KV handoff and ``pos0 = prompt_len``).
        ``row_budget [B]`` masks a row's tokens at index ≥ budget to −1.
        With a manager, per-row data (``row_budget`` / ``row_critical``)
        plans the schedule on the exact ragged ledger (step ``i`` bills
        only rows still live); otherwise ``account_rows`` rows (default
        ``B``) are billed every step. Returns the tokens and the per-step
        profile trace."""
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
        logits, caches = self._prefill(int(schedule[0]), prompts,
                                       self.scfg.slots, prompt_len)
        pos0 = torch.as_tensor(
            np.full((b,), s, np.int32) if prompt_len is None
            else np.asarray(prompt_len, np.int32), device=self.device)
        rb = (np.full((b,), max_new, np.int32) if row_budget is None
              else np.asarray(row_budget, np.int32))
        toks, pids, _ = T.decode_many(
            self.params, self.cfg, self.engine.table, schedule, logits, pos0,
            caches, row_budget=rb, prequant=self.prequant,
            paged_backend=self.paged_backend, kv_table=self.kv_table)
        names = self.engine.profile_names
        # repro: allow(host-sync) the call's single decode sync, at the end
        return {"tokens": toks.cpu().tolist(),
                "profile_trace": [names[int(p)] for p in pids]}

    def generate_stepwise(self, prompts: np.ndarray, max_new: int,  # repro: allow(host-sync) seed oracle syncs per token by design
                          accuracy_critical: bool = False) -> dict:
        """The reference's per-token host loop (one decode step and one
        host argmax per token), kept as :meth:`generate`'s oracle: the
        profile is selected and billed (``B`` inferences) before the
        prefill and before every step."""
        b, s = prompts.shape
        names = self.engine.profile_names
        pid = self._select_profile(accuracy_critical)
        logits, caches = self._prefill(pid, prompts, self.scfg.slots)
        if self.manager is not None:
            self.manager.account(pid, b)    # prefill billed like an inference
        nxt = logits.float().cpu().numpy().argmax(axis=-1).astype(np.int32)
        out, trace = [nxt], [names[pid]]
        for step in range(max_new - 1):
            pid = self._select_profile(accuracy_critical)
            pos = torch.full((b,), s + step, dtype=torch.int32,
                             device=self.device)
            tok = torch.as_tensor(nxt[:, None], device=self.device)
            logits, caches = T.decode_step(
                self.profile_params(pid), self.cfg, self.engine.table[pid],
                tok, pos, caches, paged_backend=self.paged_backend,
                kv_sched=self.kv_sched(pid))
            if self.manager is not None:
                self.manager.account(pid, b)
            nxt = logits.float().cpu().numpy().argmax(axis=-1).astype(np.int32)
            out.append(nxt)
            trace.append(names[pid])
        return {"tokens": np.stack(out, axis=1).tolist(),
                "profile_trace": trace}

    def serve(self, requests: Sequence[Request]) -> list[dict]:
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
        otherwise, where the reference asserts)."""
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
                                prompt_len=plen, row_critical=crit)
            for row, i in enumerate(group):
                mn = requests[i].max_new
                results[i] = {"tokens": out["tokens"][row][:mn],
                              "profile_trace": out["profile_trace"][:mn]}
        return results

    # ------------------------------------------------------ continuous path
    def admit(self, pid: int, prompts: np.ndarray, prompt_len: np.ndarray,
              slots_idx: np.ndarray, tok: torch.Tensor, pos: torch.Tensor,
              caches: dict) -> torch.Tensor:
        """One admission wave into the contiguous pool (the reference's
        ``admit_fn``): a ragged prefill of the left-padded ``prompts [a,
        bucket]`` into ``[a, slots]`` rows, first tokens by on-device
        argmax, and each row written whole over pool row ``slots_idx[j]``
        (a retired request's stale ``token_idx`` entries, or its SSM state
        ``h``/``conv``, must not survive). Wave rows whose ``slots_idx``
        is out of range (padding) are skipped, where the reference's
        scatter drops them. Updates ``tok``/``pos``/``caches`` in place
        and returns the wave's first tokens ``[a]``."""
        logits, rows = self._prefill(pid, prompts, self.scfg.slots,
                                     prompt_len)
        tok0 = logits.argmax(dim=-1).to(torch.int32)
        sidx = np.asarray(slots_idx)
        live = np.nonzero(sidx < tok.shape[0])[0]
        j = torch.as_tensor(live, device=self.device)
        s = torch.as_tensor(sidx[live], device=self.device)
        for key in caches:                       # "kv" and/or "ssm"
            _write_rows(caches[key], rows[key], s, j)
        tok[s] = tok0[j]
        pos[s] = torch.as_tensor(np.asarray(prompt_len)[live],
                                 dtype=torch.int32, device=self.device)
        return tok0

    def admit_paged(self, pid: int, prompts: np.ndarray,
                    prompt_len: np.ndarray, slots_idx: np.ndarray,
                    dest: np.ndarray, tok: torch.Tensor, pos: torch.Tensor,
                    caches: dict):
        """One paged admission wave: a ragged prefill of the left-padded
        ``prompts [a, bucket]`` into transient dense rows, first tokens by
        on-device argmax, and a scatter of the rows into the pool at
        physical blocks ``dest [a, n_lblk]``. Wave rows whose ``slots_idx``
        is out of range (padding) and table entries outside the pool are
        skipped — the host filters them, where the reference's scatter
        drops them. Updates ``tok``/``pos``/``caches`` in place and returns
        ``(tok0 [a], raw)``: ``raw`` is the wave's pre-quantization K/V
        (:func:`~repro_torch.models.transformer.prefill`'s
        ``return_raw_kv``) when the server keeps masters, else ``None``."""
        out = self._prefill(pid, prompts, self.slots_p, prompt_len,
                            return_raw_kv=self._collect_masters)
        raw = out[2] if self._collect_masters else None
        tok0 = self._land(out[0], out[1], np.asarray(prompt_len), slots_idx,
                          dest, None, tok, pos, caches)
        return tok0, raw

    def admit_shared(self, pid: int, prompts: np.ndarray,
                     suffix_len: np.ndarray, slots_idx: np.ndarray,
                     dest: np.ndarray, bt_rows: np.ndarray,
                     prefix_k: torch.Tensor, prefix_v: torch.Tensor,
                     k_amax: Optional[torch.Tensor],
                     v_amax: Optional[torch.Tensor], prefix_len: np.ndarray,
                     tok: torch.Tensor, pos: torch.Tensor, caches: dict):
        """One continuation wave (shared-prefix admissions, chunks): a
        continuation prefill of the left-padded suffixes ``prompts [a, sb]``
        (``suffix_len [a]``) over the prefix K/V ``prefix_k``/``prefix_v
        [L, a, Pp, Hkv, hd]`` (``prefix_len [a]`` real tokens; raw amaxes
        ``[L, a, Hkv]`` or ``None``), then the block scatter of
        :meth:`admit_paged` with ``dest`` out of the pool on shared blocks
        (never written — that skipped write is the copy-on-write) and
        ``bt_rows`` installed as the rows' tables (the shared blocks
        mapped, then the private tail). This is the master-replay variant;
        :meth:`admit_shared_pool` gathers the prefix from the pool.
        Returns ``(tok0 [a], raw suffix K/V or None)``."""
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=self.device),
                 "prompt_len": np.asarray(suffix_len, np.int32)}
        plen = np.asarray(prefix_len, np.int32)
        out = T.prefill_extend(
            self.profile_params(pid), self.cfg, self.engine.table[int(pid)],
            batch, self.slots_p, kv_bits=self.scfg.kv_bits,
            prefix_k=prefix_k, prefix_v=prefix_v, prefix_len=plen,
            prefix_k_amax=k_amax, prefix_v_amax=v_amax,
            return_raw_kv=self._collect_masters, kv_sched=self.kv_sched(pid))
        raw = out[2] if self._collect_masters else None
        tok0 = self._land(out[0], out[1], plen + np.asarray(suffix_len),
                          slots_idx, dest, bt_rows, tok, pos, caches)
        return tok0, raw

    def admit_shared_pool(self, pid: int, prompts: np.ndarray,
                          suffix_len: np.ndarray, slots_idx: np.ndarray,
                          dest: np.ndarray, bt_rows: np.ndarray,
                          pre_bids: np.ndarray, prefix_len: np.ndarray,
                          tok: torch.Tensor, pos: torch.Tensor,
                          caches: dict):
        """:meth:`admit_shared` for a bf16 pool, whose blocks are the
        masters: the prefix K/V are gathered from pool blocks ``pre_bids
        [a, Pp / bs]`` as f32 (entries outside the pool read as zeros)."""
        pool = caches["kv"]
        a, pb = pre_bids.shape
        ok, idx = _mapped(torch.as_tensor(pre_bids, device=self.device),
                          pool.n_blocks)

        def gather(x):                           # [L, nb + 1, bs, Hkv, hd]
            g = torch.where(ok[None, :, :, None, None, None],
                            x[:, idx].float(), 0.0)
            return g.reshape(x.shape[0], a, pb * x.shape[2], *x.shape[3:])

        return self.admit_shared(pid, prompts, suffix_len, slots_idx, dest,
                                 bt_rows, gather(pool.k), gather(pool.v),
                                 None, None, prefix_len, tok, pos, caches)

    def _land(self, logits, rows, row_len, slots_idx, dest, bt_rows, tok,
              pos, caches) -> torch.Tensor:
        """Finish a paged wave: first tokens by on-device argmax, the block
        scatter of the live wave rows, their SSM state written whole on a
        hybrid stack (a new row must not decode from its slot's previous
        occupant's state), and their carry (``pos`` = each row's token
        count ``row_len``). Returns the wave's first tokens."""
        tok0 = logits.argmax(dim=-1).to(torch.int32)
        sidx = np.asarray(slots_idx)
        live = np.nonzero(sidx < tok.shape[0])[0]
        self._scatter_blocks(caches["kv"], rows["kv"], np.asarray(dest),
                             sidx, live,
                             None if bt_rows is None else np.asarray(bt_rows))
        j = torch.as_tensor(live, device=self.device)
        s = torch.as_tensor(sidx[live], device=self.device)
        if "ssm" in caches:
            _write_rows(caches["ssm"], rows["ssm"], s, j)
        tok[s] = tok0[j]
        pos[s] = torch.as_tensor(np.asarray(row_len)[live],
                                 dtype=torch.int32, device=self.device)
        return tok0

    def _scatter_blocks(self, pool, rows, dest: np.ndarray,
                        sidx: np.ndarray, live: np.ndarray,
                        bt_rows: Optional[np.ndarray] = None) -> None:
        """Cut each live wave row of the stacked dense cache ``rows``
        (``[L, a, slots_p, ...]``) into ``n_lblk`` blocks and write the
        blocks whose ``dest`` entry is in the pool; install the rows' block
        tables and scales at pool rows ``sidx``. The table is ``bt_rows``
        where given — it differs from ``dest`` exactly on shared blocks,
        which are mapped but not written — else ``dest``."""
        nlb, bs, L = self.n_lblk, self.block_size, self.cfg.n_layers
        a = dest.shape[0]
        d = dest[live]
        jj, ll = np.nonzero((d >= 0) & (d < pool.n_blocks))
        dev = self.device
        src_j = torch.as_tensor(live[jj], device=dev)
        src_l = torch.as_tensor(ll, device=dev)
        dst = torch.as_tensor(d[jj, ll], dtype=torch.int64, device=dev)

        def blk(x):
            return x.reshape(L, a, nlb, bs, *x.shape[3:])

        for name in ("k", "v", "token_idx"):
            getattr(pool, name)[:, dst] = blk(getattr(rows, name))[:, src_j,
                                                                   src_l]
        s = torch.as_tensor(sidx[live], device=dev)
        j = torch.as_tensor(live, device=dev)
        table = d if bt_rows is None else bt_rows[live]
        pool.block_table[:, s] = torch.as_tensor(
            table, dtype=torch.int32, device=dev)[None].expand(L, -1, -1)
        pool.k_scale[:, s] = rows.k_scale[:, j]
        pool.v_scale[:, s] = rows.v_scale[:, j]

    def segment(self, schedule: np.ndarray, tok: torch.Tensor,
                pos: torch.Tensor, caches: dict, remaining: np.ndarray,
                fault_step: Optional[np.ndarray] = None):
        """One decode segment over the pool (``decode_segment`` on the
        server's images and backend). ``fault_step [B]`` poisons a row's
        logits with NaN at that step (−1: never). Returns ``(tokens,
        row_ok, tok, pos, caches)``."""
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
                     fault_step: Optional[np.ndarray] = None):
        """One speculative segment over the pool: ``len(schedule)``
        draft/verify windows (``decode_segment_spec`` on the server's
        images, backend and drafter). ``hist``/``spec_on``/``quota`` are
        the host's per-row drafter history, opt-out mask and quantum in
        delivered tokens; ``fault_step [B]`` poisons a row's verify window
        at that index (−1: never). Returns ``(tokens, delivered, row_ok,
        tok, pos, caches)``."""
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
