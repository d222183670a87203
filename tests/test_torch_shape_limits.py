"""Shapes at the edges of the paged-attention kernels, on the smoke
granite-3-2b config with the reference's weights, against the JAX
reference (its ``paged_backend="gather"`` as the oracle, which keeps the
tests fast):

* a speculative window wider than the first port's K2 took (draft_k 32:
  W·Hg = 66) constructs on the kernel backend and serves JAX's tokens;
* a kv8 model outside K4's limits is refused when the server is built,
  naming the gather backend, not at the first decode;
* block size 128 (above the first port's K1 limit of 64) constructs
  through the launcher and serves JAX's tokens;
* the ring wrap (prompt + max_new > slots) on the paged pool at kv16, kv8
  and kv4 serves JAX's tokens on both backends.

On the CPU the kernel backend runs the kernels' plain versions; the kernels
themselves are held to those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 2, 4 and 5).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.profiles import paper_profiles
from repro.models import transformer as JT
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.launch import serve as S
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from torch_threads import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke("granite-3-2b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    jeng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                          QuantIndex(names), lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names, inner_layers=[])),
                             TE.QuantIndex(names))
    return cfg, C.get_smoke("granite-3-2b"), jp, tp, jeng, teng


def _both(parts, reqs, scfg, quantum=4, backends=("kernel",)):
    """JAX's scheduler (gather backend) and the port's on each backend over
    the same requests; returns the JAX results and the port's per
    backend."""
    cfg, tcfg, jp, tp, jeng, teng = parts
    scfg = dict(scfg, prefix_cache=False)
    js = JScheduler(JServer(cfg, jp, jeng, JConfig(
        paged_backend="gather", **scfg)), quantum=quantum)
    for t, m in reqs:
        js.submit(JRequest(tokens=t, max_new=m))
    want = js.run()
    got = {}
    for backend in backends:
        ts = ContinuousScheduler(AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg), device="cpu"), quantum=quantum)
        for t, m in reqs:
            ts.submit(Request(tokens=t, max_new=m))
        got[backend] = ts.run()
        assert ts.admission_log == js.admission_log
    return want, got


def _requests(seed, shape, vocab=512):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), m) for n, m in shape]


def test_wide_window_constructs_and_serves_jax_tokens(parts):
    """draft_k 32 on the smoke config (Hg 2): W·Hg = 66 query rows per
    (row, KV head), which the first port's K2 refused (limit 64)."""
    reqs = _requests(41, [(9, 10), (5, 12), (14, 7)])
    scfg = dict(slots=64, max_batch=4, kv_bits=16, block_size=8,
                speculate=True, draft_k=32)
    want, got = _both(parts, reqs, scfg)
    for g, w in zip(got["kernel"], want):
        assert g["tokens"] == w["tokens"]
        assert g["status"].value == w["status"].value == "completed"


@pytest.mark.parametrize("change,msg", [
    (dict(n_heads=34, n_kv=2), "Hg=17"),          # Hg <= 16
    (dict(head_dim=18), "multiple of 4"),           # D % 4 == 0
])
def test_k4_limits_raise_at_construction(parts, change, msg):
    """kv8 reads a contiguous cache through K4; a model it cannot take is
    refused when the server is built, on the paged pool and the contiguous
    one, with the gather backend named."""
    _, tcfg, _, tp, _, teng = parts
    cfg = dataclasses.replace(tcfg, **change)
    for paged in (True, False):
        with pytest.raises(ValueError, match=f"K4.*{msg}.*gather"):
            AdaptiveServer(cfg, tp, teng, ServingConfig(
                slots=32, kv_bits=8, paged_kv=paged, paged_backend="kernel"),
                device="cpu")


def test_gather_backend_serves_what_the_kernels_refuse():
    """The refusal's advice holds: Hg 17 at kv8 builds and serves on the
    gather backend."""
    cfg = dataclasses.replace(C.get_smoke("granite-3-2b"), n_heads=34,
                              n_kv=2)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    names = T.quant_layer_names(cfg)
    engine = TE.AdaptiveEngine(tuple(TP.paper_profiles(names)),
                               TE.QuantIndex(names))
    srv = AdaptiveServer(cfg, params, engine, ServingConfig(
        slots=32, kv_bits=8, paged_backend="gather"), device="cpu")
    out = srv.serve([Request(tokens=np.arange(5, dtype=np.int32),
                             max_new=3)])
    assert len(out[0]["tokens"]) == 3


def test_block_size_128_constructs_and_serves_jax_tokens(parts):
    """``--continuous --block-size 128`` builds on the kernel backend
    (the launcher's own path), and the scheduler at block size 128 serves
    JAX's tokens on both backends."""
    args = S.parse_args(["--continuous", "--block-size", "128",
                         "--paged-backend", "kernel", "--device", "cpu",
                         "--requests", "2", "--max-new", "3"])
    cfg, srv = S.build_server(args)
    assert srv.block_size == 128 and srv.paged_backend == "kernel"
    out = S.serve(srv, S.make_requests(cfg, args), args.quantum,
                  continuous=True)
    assert [len(r["tokens"]) for r in out["results"]] == [3, 3]

    reqs = _requests(43, [(7, 6), (20, 9), (3, 5)])
    scfg = dict(slots=256, max_batch=4, kv_bits=8, block_size=128)
    want, got = _both(parts, reqs, scfg, backends=("kernel", "gather"))
    for backend, res in got.items():
        for g, w in zip(res, want):
            assert g["tokens"] == w["tokens"], backend


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_ring_wrap_matches_reference(parts, kv_bits):
    """prompt + max_new > slots (32): the paged ring wraps onto the row's
    first blocks, and both backends serve JAX's tokens."""
    reqs = _requests(47 + kv_bits, [(30, 12), (12, 25), (26, 9), (5, 4)])
    scfg = dict(slots=32, max_batch=4, kv_bits=kv_bits, block_size=8)
    want, got = _both(parts, reqs, scfg, backends=("kernel", "gather"))
    for backend, res in got.items():
        for g, w in zip(res, want):
            assert g["tokens"] == w["tokens"], backend
            assert len(g["tokens"]) == len(w["tokens"])
