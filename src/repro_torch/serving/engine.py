"""Adaptive serving engine (port of ``repro/serving/engine.py``, the
continuous-batching primitives on the paged pool).

The reference's jitted closures become methods that update the scheduler's
pool tensors in place (its donated carries). Profile adaptivity stays
bits-as-data: a profile id indexes the host bits table and the per-profile
weight images, so switching profiles loads nothing.

Admission prefills run on the prequantized weight images rather than on the
float masters. That is the reference's arithmetic: fake-quant is
elementwise once its per-tensor scale is fixed, so quantizing the master
per call (the reference) and once up front (here) give the same values.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import AdaptiveEngine
from repro_torch.core.manager import ProfileManager
from repro_torch.models import transformer as T
from repro_torch.runtime import resolve_device

__all__ = ["ServingConfig", "AdaptiveServer", "Request", "RequestStatus"]


class RequestStatus(str, enum.Enum):
    """Terminal outcome of one request (the reference's enum; this slice
    reaches ``COMPLETED`` only — cancellation, deadlines, shedding and
    quarantine come with the fault-tolerance slice)."""

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
    """Deployment knobs. Only the fields this port implements exist; later
    slices add theirs as they port them, so no field is silently ignored.

    ``slots`` — per-row KV capacity in tokens (must cover ``prompt_len +
    max_new``). ``kv_bits`` — KV storage: 16 (bf16), 8 (int8), 4 (packed
    int4) or 32 (f32, gather backend only). ``max_batch`` — rows of the
    scheduler's slot pool. ``block_size`` — tokens per KV block.
    ``pool_blocks`` — physical blocks (``None``: ``max_batch ·
    ceil(slots / block_size)``, the contiguous footprint).
    ``paged_backend`` — ``"kernel"`` attends in place through the paged-
    attention kernel, ``"gather"`` builds the per-segment dense view,
    ``"auto"`` is the kernel on CUDA and gather on the CPU.

    Speculative decoding: ``speculate`` decodes through draft/verify
    windows — each segment window proposes ``draft_k`` tokens per row and
    verifies the ``draft_k + 1`` window in one batched forward
    (:func:`repro_torch.models.transformer.decode_segment_spec`),
    delivering 1..``draft_k + 1`` tokens per row, the same tokens as greedy
    decode. Needs a ``supports_speculation`` stack (full causal attention,
    kv16/kv8). ``draft_hist`` is the token history the n-gram drafter
    sees. ``draft_model``: ``None``/``"ngram"`` = the n-gram drafter,
    ``"repeat"`` = repeat the current token; a small-model drafter plugs
    in as :class:`AdaptiveServer`'s ``draft_fn``.
    """

    slots: int = 4096
    kv_bits: int = 16
    max_batch: int = 8
    block_size: int = 16
    pool_blocks: Optional[int] = None
    paged_backend: str = "auto"
    speculate: bool = False
    draft_k: int = 4
    draft_hist: int = 32
    draft_model: Optional[str] = None


@dataclasses.dataclass
class Request:
    """One generation request: a ``[S]`` int32 prompt, a token budget, and
    the paper's accuracy-critical flag. ``priority``/``deadline_ms`` are the
    reference's fields; the FIFO policy ignores the first and this slice
    does not implement the second (it must stay ``None``)."""

    tokens: np.ndarray
    max_new: int = 32
    accuracy_critical: bool = False
    priority: int = 1
    deadline_ms: Optional[float] = None


class AdaptiveServer:
    """Serving primitives over one model: the per-profile weight images,
    paged admission waves, decode segments and row clearing, shared by every
    :class:`~repro_torch.serving.scheduler.ContinuousScheduler` built on it.

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
        pb = serving.paged_backend
        if pb not in ("auto", "kernel", "gather"):
            raise ValueError(f"paged_backend must be auto|kernel|gather, "
                             f"got {pb!r}")
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
            if pb == "kernel":
                from repro_torch.kernels import paged_attention as PA
                rows = (serving.draft_k + 1) * (cfg.n_heads // cfg.n_kv)
                if rows > PA.MAX_WHG or rows * cfg.hd > PA.MAX_WHG_D:
                    raise ValueError(
                        f"the window kernel takes W·Hg <= {PA.MAX_WHG} and "
                        f"W·Hg·D <= {PA.MAX_WHG_D}; draft_k="
                        f"{serving.draft_k} gives W·Hg={rows}, D={cfg.hd}")
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
        self.paged_backend = pb
        self.block_size = T.paged_block_size(cfg, serving.slots,
                                             serving.block_size)
        self.n_lblk = -(-serving.slots // self.block_size)
        self.slots_p = self.n_lblk * self.block_size     # virtual row length
        # per-profile weight images, built once per server
        self.prequant = T.prequant_decode_weights(params, cfg, engine.table)

    def profile_params(self, pid: int) -> dict:
        """``params`` with profile ``pid``'s weight images grafted on."""
        return T.overlay_params(self.params, self.prequant[int(pid)])

    def admit_paged(self, pid: int, prompts: np.ndarray,
                    prompt_len: np.ndarray, slots_idx: np.ndarray,
                    dest: np.ndarray, tok: torch.Tensor, pos: torch.Tensor,
                    caches: dict) -> torch.Tensor:
        """One paged admission wave: a ragged prefill of the left-padded
        ``prompts [a, bucket]`` into transient dense rows, first tokens by
        on-device argmax, and a scatter of the rows into the pool at
        physical blocks ``dest [a, n_lblk]``. Wave rows whose ``slots_idx``
        is out of range (padding) and table entries outside the pool are
        skipped — the host filters them, where the reference's scatter
        drops them. Updates ``tok``/``pos``/``caches`` in place and returns
        the wave's first tokens ``[a]``."""
        bits = self.engine.table[int(pid)]
        batch = {"tokens": torch.as_tensor(prompts, device=self.device),
                 "prompt_len": np.asarray(prompt_len)}
        logits, rows = T.prefill(self.profile_params(pid), self.cfg, bits,
                                 batch, self.slots_p,
                                 kv_bits=self.scfg.kv_bits)
        tok0 = logits.argmax(dim=-1).to(torch.int32)
        live = np.nonzero(np.asarray(slots_idx) < tok.shape[0])[0]
        self._scatter_blocks(caches["kv"], rows["kv"], np.asarray(dest),
                             np.asarray(slots_idx), live)
        j = torch.as_tensor(live, device=self.device)
        s = torch.as_tensor(np.asarray(slots_idx)[live], device=self.device)
        tok[s] = tok0[j]
        pos[s] = torch.as_tensor(np.asarray(prompt_len)[live],
                                 dtype=torch.int32, device=self.device)
        return tok0

    def _scatter_blocks(self, pool, rows, dest: np.ndarray,
                        sidx: np.ndarray, live: np.ndarray) -> None:
        """Cut each live wave row of the stacked dense cache ``rows``
        (``[L, a, slots_p, ...]``) into ``n_lblk`` blocks and write the
        blocks whose ``dest`` entry is in the pool; install ``dest`` as the
        rows' block tables and their scales at pool rows ``sidx``."""
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
        pool.block_table[:, s] = torch.as_tensor(
            d, dtype=torch.int32, device=dev)[None].expand(L, -1, -1)
        pool.k_scale[:, s] = rows.k_scale[:, j]
        pool.v_scale[:, s] = rows.v_scale[:, j]

    def segment(self, schedule: np.ndarray, tok: torch.Tensor,
                pos: torch.Tensor, caches: dict, remaining: np.ndarray,
                fault_step: Optional[np.ndarray] = None):
        """One decode segment over the pool (``decode_segment`` on the
        server's images and backend). Returns ``(tokens, row_ok, tok, pos,
        caches)``."""
        fs = (None if fault_step is None else
              torch.as_tensor(fault_step, dtype=torch.int32,
                              device=self.device))
        return T.decode_segment(self.params, self.cfg, self.engine.table,
                                schedule, tok, pos, caches, remaining,
                                prequant=self.prequant,
                                paged_backend=self.paged_backend,
                                fault_step=fs)

    def segment_spec(self, schedule: np.ndarray, hist: np.ndarray,
                     spec_on: np.ndarray, tok: torch.Tensor,
                     pos: torch.Tensor, caches: dict, remaining: np.ndarray,
                     quota: np.ndarray):
        """One speculative segment over the pool: ``len(schedule)``
        draft/verify windows (``decode_segment_spec`` on the server's
        images, backend and drafter). ``hist``/``spec_on``/``quota`` are
        the host's per-row drafter history, opt-out mask and quantum in
        delivered tokens. Returns ``(tokens, delivered, row_ok, tok, pos,
        caches)``."""
        return T.decode_segment_spec(
            self.params, self.cfg, self.engine.table, schedule, tok, pos,
            caches, remaining, quota=quota,
            hist0=torch.as_tensor(hist, device=self.device),
            spec_on=torch.as_tensor(spec_on, device=self.device),
            prequant=self.prequant, paged_backend=self.paged_backend,
            draft_k=self.scfg.draft_k, draft_fn=self.draft_fn)

    def clear_rows(self, slots_idx, caches: dict) -> dict:
        """Unmap the block tables of pool rows ``slots_idx`` (retirement),
        so a retired row's residual writes land in the write sink."""
        pool = caches["kv"]
        s = [int(x) for x in slots_idx if 0 <= int(x) < pool.block_table.shape[1]]
        if s:
            pool.block_table[:, torch.as_tensor(s, device=self.device)] = \
                pool.n_blocks
        return caches
