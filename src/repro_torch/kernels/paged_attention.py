"""Paged decode attention: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``paged_attention_pallas``
(``repro/kernels/paged_attention.py``). The CUDA source is
``csrc/paged_attention.cu``; it is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface at first use (into
``build/repro_torch/`` at the repository root) and called through
``ctypes``.

Layout (the reference's, see :class:`repro_torch.models.attention.
PagedKVCache`):

  q        [B, Hkv, Hg, D]          f32 or bf16 — one decode token per row
  k/v pool [nb, bs, Hkv, D]         bf16 (kv16) or int8 (kv8);
           [nb, bs, Hkv, D/2]       int8 at kv4, two nibbles per byte
  tidx     [nb, bs]                 int32 absolute token index, −1 = empty
  scales   [B, Hkv]                 f32 per-row dequant scales (kv8/kv4)
  bt       [B, n_lblk]              int32 block table
  pos      [B]                      int32 current absolute position
  → out    [B, Hkv, Hg, D]          f32

An entry is mapped iff ``0 <= entry < n_blocks`` (``n_blocks`` defaults to
the pool's block count; the port's pools pass it explicitly because they
carry a write-sink block past it).

:func:`paged_attention` runs the plain version for CPU tensors and the
kernel for CUDA tensors — it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.qtypes import unpack_int4

__all__ = ["paged_attention", "paged_attention_ref", "build",
           "SOURCE", "BUILD_DIR", "MAX_D", "MAX_HG", "MAX_BS"]

NEG_INF = -1e30
SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
MAX_D, MAX_HG, MAX_BS = 256, 16, 64


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, k_scale: torch.Tensor,
                        v_scale: torch.Tensor, token_idx: torch.Tensor,
                        block_table: torch.Tensor, pos: torch.Tensor, *,
                        bits: int = 16, window: int = 0,
                        n_blocks: Optional[int] = None) -> torch.Tensor:
    """Plain version (port of ``repro/kernels/ref.py::paged_attention_ref``):
    a dense gather of each row's blocks (unmapped entries fill with zeros /
    ``token_idx`` −1), then the masked softmax of ``decode_attention`` in
    its operation order — kv8 contracts on the int grid and scales the
    scores and the output, kv4 unpacks and dequantizes first. Rows with no
    attendable key return exact zeros."""
    b, hkv, hg, d = q.shape
    bs = token_idx.shape[1]
    n_lblk = block_table.shape[1]
    nb = k_pool.shape[0] if n_blocks is None else int(n_blocks)
    ok = (block_table >= 0) & (block_table < nb)
    idx = torch.where(ok, block_table, 0).long()

    def gather(pool, fill):
        g = pool[idx]                                   # [B, n_lblk, bs, ...]
        mask = ok.reshape(b, n_lblk, *([1] * (g.ndim - 2)))
        g = torch.where(mask, g, torch.full((), fill, dtype=g.dtype,
                                            device=g.device))
        return g.reshape(b, n_lblk * bs, *pool.shape[2:])

    ks = k_scale.float().reshape(b, hkv)
    vs = v_scale.float().reshape(b, hkv)
    if bits == 4:
        kf = unpack_int4(gather(k_pool, 0)).float() * ks[:, None, :, None]
        vf = unpack_int4(gather(v_pool, 0)).float() * vs[:, None, :, None]
    else:
        kf = gather(k_pool, 0).float()                  # [B, S, Hkv, D]
        vf = gather(v_pool, 0).float()
    tidx = gather(token_idx, -1)                        # [B, S]
    qh = q.float() * d ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qh, kf)
    if bits == 8:
        scores = scores * ks[:, :, None, None]
    win = window if window > 0 else n_lblk * bs + 1
    p_ = pos.long()[:, None]
    keep = (tidx >= 0) & (tidx <= p_) & (p_ - tidx < win)
    scores = torch.where(keep[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vf)
    if bits == 8:
        out = out * vs[:, :, None, None]
    alive = keep.any(dim=-1)[:, None, None, None]
    return torch.where(alive, out, torch.zeros((), device=out.device))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_LIB: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the paged-attention kernel is built "
                       "on the machine with the GPU")


def build(verbose: bool = False) -> dict:
    """Compile the kernel (once per source content) and load it.

    Returns ``{"lib", "path", "seconds", "ptxas"}``: ``seconds`` is this
    call's build time (0 when the library was already built) and ``ptxas``
    the compiler's register / shared-memory report.
    """
    if "lib" in _LIB:
        return _LIB
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libpaged_attention_{tag}.so"
    log = so.with_suffix(".ptxas.txt")
    t0 = time.perf_counter()
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    fn = lib.repro_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    _LIB.update(lib=lib, path=str(so), seconds=seconds,
                ptxas=log.read_text() if log.exists() else "")
    if verbose:
        print(_LIB["ptxas"])
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, k_scale: torch.Tensor,
                    v_scale: torch.Tensor, token_idx: torch.Tensor,
                    block_table: torch.Tensor, pos: torch.Tensor, *,
                    bits: int = 16, window: int = 0,
                    n_blocks: Optional[int] = None) -> torch.Tensor:
    """In-place paged decode attention; ``window <= 0`` is full attention.
    Returns ``[B, Hkv, Hg, D]`` f32. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in ``paged_attention.launches``)
    or raise."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, k_scale, v_scale,
                                   token_idx, block_table, pos, bits=bits,
                                   window=window, n_blocks=n_blocks)
    if bits not in (4, 8, 16):
        raise ValueError(f"paged kernel supports kv16/kv8/kv4, got kv{bits}")
    b, hkv, hg, d = q.shape
    nb_alloc, bs = token_idx.shape
    n_lblk = block_table.shape[1]
    nb = nb_alloc if n_blocks is None else int(n_blocks)
    if not (d % 2 == 0 and d <= MAX_D and hg <= MAX_HG and bs <= MAX_BS):
        raise ValueError(f"unsupported shape: D={d} (even, <= {MAX_D}), "
                         f"Hg={hg} (<= {MAX_HG}), bs={bs} (<= {MAX_BS})")
    if not 0 <= nb <= nb_alloc:
        raise ValueError(f"n_blocks={nb} exceeds the pool's {nb_alloc}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be f32 or bf16, got {q.dtype}")
    _check(q, "q", q.dtype, (b, hkv, hg, d))
    kv_dtype = torch.bfloat16 if bits == 16 else torch.int8
    dk = d // 2 if bits == 4 else d
    _check(k_pool, "k_pool", kv_dtype, (nb_alloc, bs, hkv, dk))
    _check(v_pool, "v_pool", kv_dtype, (nb_alloc, bs, hkv, dk))
    _check(token_idx, "token_idx", torch.int32, (nb_alloc, bs))
    _check(k_scale, "k_scale", torch.float32, (b, hkv))
    _check(v_scale, "v_scale", torch.float32, (b, hkv))
    _check(block_table, "block_table", torch.int32, (b, n_lblk))
    _check(pos, "pos", torch.int32, (b,))
    out = torch.empty((b, hkv, hg, d), dtype=torch.float32, device=q.device)
    lib = build()["lib"]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        token_idx.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hkv, hg, d, nb, bs, n_lblk,
        bits, int(window), float(d ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: CUDA "
                           f"error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
