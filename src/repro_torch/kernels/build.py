"""Build and bind the port's CUDA kernels.

Every source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use (into
``build/repro_torch/`` at the repository root; one ``nvcc`` per source, all
started together, so the build takes as long as the slowest source) and
called through ``ctypes``. Each C entry point returns ``cudaGetLastError()``
of its launch; the wrappers raise when it is not 0. Headers shared between
sources (``csrc/*.cuh``) are part of every source's build tag, so a change to
one rebuilds each library.
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

import torch

__all__ = ["build", "lib", "check", "target", "SOURCES", "BUILD_DIR", "SM_COUNT"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"paged_attention": _CSRC / "paged_attention.cu",
           "paged_attention_multi": _CSRC / "paged_attention_multi.cu",
           "qmatmul": _CSRC / "qmatmul.cu",
           "aquant": _CSRC / "aquant.cu",
           "qkv_attention": _CSRC / "qkv_attention.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SM_COUNT = 132                # streaming multiprocessors of an H100 SXM

_LIBS: dict = {}

# ctypes signatures of the C entry points (pointers, ints, floats, stream)
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
_ARGTYPES = {
    "paged_attention": [_P] * 11 + [_I] * 15 + [_F, _P],
    "paged_attention_multi": [_P] * 11 + [_I] * 15 + [_F, _P],
    "qmatmul": [_P] * 5 + [_I] * 10 + [_F] * 3 + [_P],
    "aquant": [_P] * 4 + [_L] + [_I] * 8 + [_P],
    "qkv_attention": [_P] * 9 + [_I] * 9 + [_L] * 6 + [_F, _P],
}
# further entry points of a source: K5's occupancy query and its step 0
_EXTRA_ARGTYPES = {
    "aquant": {"repro_aquant_blocks_per_sm": [_I] * 3,
               "repro_aquant_step0": [_P] * 4 + [_L] + [_I] * 4 + [_P]},
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on the machine with the GPU")


def build(verbose: bool = False) -> dict:
    """Compile every kernel source (once per source content) and load it.

    The ``nvcc`` processes of all sources not yet built start together and
    run in parallel. Returns ``{name: {"lib", "path", "seconds",
    "ptxas"}}``: ``seconds`` is the wall time of this call's build (0 when
    the library was already built) and ``ptxas`` the compiler's register /
    shared-memory / spill report.
    """
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    for name, src in SOURCES.items():
        tag = hashlib.sha1(src.read_bytes() + headers).hexdigest()[:12]
        so = BUILD_DIR / f"lib{name}_{tag}.so"
        if so.exists():
            jobs[name] = (so, None, None)
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(src)]
        jobs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (so, tmp, proc) in jobs.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
            continue
        so.with_suffix(".ptxas.txt").write_text(out)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    for name, (so, _, proc) in jobs.items():
        cdll = ctypes.CDLL(str(so))
        fn = getattr(cdll, f"repro_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        for sym, argtypes in _EXTRA_ARGTYPES.get(name, {}).items():
            extra = getattr(cdll, sym)
            extra.restype = ctypes.c_int
            extra.argtypes = argtypes
        log = so.with_suffix(".ptxas.txt")
        _LIBS[name] = {"lib": cdll, "path": str(so),
                       "seconds": seconds if proc is not None else 0.0,
                       "ptxas": log.read_text() if log.exists() else ""}
        if verbose:
            print(_LIBS[name]["ptxas"])
    return _LIBS


def lib(name: str):
    """The loaded library of source ``name`` (building every source first
    if needed)."""
    return build()[name]["lib"]


def target(t: torch.Tensor) -> str:
    """The device a wrapper holds a call's operands to: ``meta`` for a
    meta call (validated as a CUDA one, then shape arithmetic), else
    ``cuda``."""
    return "meta" if t.device.type == "meta" else "cuda"


def check(t: torch.Tensor, name: str, dtype, shape,
          device: str = "cuda") -> None:
    """Raise unless ``t`` is a contiguous ``device`` tensor (see
    :func:`target`) of ``dtype`` and ``shape``."""
    if t.device.type != device:
        kind = "CUDA" if device == "cuda" else device
        raise ValueError(f"{name} must be a {kind} tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
