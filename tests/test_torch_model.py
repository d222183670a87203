"""The dense model of the PyTorch port against the JAX reference on the
granite-3-2b smoke config, with the reference's weights (``params_from_jax``).

* ragged prefill logits, every paper profile (``atol=1e-4``: f32 on both
  sides; the A16 profiles carry the reference's inexact pow2 scale);
* a paged admission wave (fragmented block tables) followed by decode
  segments that switch profiles step by step, with a row finishing
  mid-segment and a never-admitted row: greedy tokens identical to the
  reference's gather backend at kv16, kv8 and kv4, and the port's kernel
  backend (its plain version on the CPU) identical to its gather backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.profiles import paper_profiles
from repro.models import transformer as JT
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import ServingConfig as JConfig
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import AdaptiveServer, ServingConfig
from torch_threads import _one_thread  # noqa: F401

PLENS = (4, 9, 17)


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke("granite-3-2b")
    jp = JT.init_params(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    names = JT.quant_layer_names(cfg)
    jeng = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names),
                          lambda *a: None)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names)),
                             TE.QuantIndex(names))
    assert np.array_equal(np.asarray(jeng.table), teng.table)
    return cfg, C.get_smoke("granite-3-2b"), jp, tp, jeng, teng


def _prompts(vocab: int, bucket: int, rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((rows, bucket), np.int32)
    plen = np.zeros((rows,), np.int32)
    for j, n in enumerate(PLENS):
        prompts[j, bucket - n:] = rng.integers(0, vocab, n)
        plen[j] = n
    return prompts, plen


def test_config_matches_reference(parts):
    cfg, tcfg = parts[:2]
    assert {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__} == \
        {f: getattr(cfg, f) for f in tcfg.__dataclass_fields__}
    assert T.quant_layer_names(tcfg) == JT.quant_layer_names(cfg)


@pytest.mark.parametrize("pid", range(6))
def test_ragged_prefill_logits(parts, pid):
    cfg, tcfg, jp, tp, jeng, teng = parts
    prompts, plen = _prompts(cfg.vocab, 32, len(PLENS))
    jl, _ = JT.prefill(jp, cfg, jnp.asarray(jeng.table)[pid],
                       {"tokens": jnp.asarray(prompts),
                        "prompt_len": jnp.asarray(plen)}, 64)
    tl, tc = T.prefill(tp, tcfg, teng.table[pid],
                       {"tokens": torch.from_numpy(prompts),
                        "prompt_len": plen}, 64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    tidx = tc["kv"].token_idx[0].numpy()
    for j, n in enumerate(PLENS):                 # logical positions, pads −1
        assert tidx[j, :n].tolist() == list(range(n))
        assert (tidx[j, n:] == -1).all()


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_paged_decode_segments_match_reference(parts, kv_bits):
    cfg, tcfg, jp, tp, jeng, teng = parts
    B, slots, bs, nb = 4, 32, 8, 14
    scfg = dict(slots=slots, max_batch=B, kv_bits=kv_bits, block_size=bs,
                pool_blocks=nb, prefix_cache=False)
    js = JServer(cfg, jp, jeng, JConfig(paged_backend="gather", **scfg))
    prompts, plen = _prompts(cfg.vocab, 32, 4, seed=kv_bits)
    sidx = np.array([2, 0, 1, B], np.int32)       # wave row 3 is padding
    dest = np.full((4, slots // bs), nb, np.int32)
    perm = np.random.default_rng(1).permutation(nb)
    for j, n in enumerate(PLENS):                 # prompt + 11 decode writes
        need = -(-(n + 11) // bs)
        dest[j, :need], perm = perm[:need], perm[need:]
    sched = [np.array([0, 2, 3, 2, 5, 1]), np.array([4, 0, 2, 2, 3, 0])]
    remaining = np.array([3, 10, 8, 0])           # slot 0 finishes in seg 1
    ref = {}
    jc = JT.init_paged_caches(cfg, B, slots, kv_bits=kv_bits, block_size=bs,
                              pool_blocks=nb)
    jtok0, _, jtok, jpos, jc = js._admit_paged(
        2, {"tokens": jnp.asarray(prompts), "prompt_len": jnp.asarray(plen)},
        jnp.asarray(sidx), jnp.asarray(dest), jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32), jc)
    ref["tok0"] = np.asarray(jtok0)[:3]
    ref["ys"] = []
    rem = remaining.copy()
    for s in sched:
        ys, _, jtok, jpos, jc = JT.decode_segment(
            jp, cfg, jnp.asarray(jeng.table), jnp.asarray(s), jtok, jpos, jc,
            jnp.asarray(rem), prequant=js._prequant, paged_backend="gather")
        ref["ys"].append(np.asarray(ys))
        rem = np.maximum(rem - len(s), 0)
    ref["bt"] = np.asarray(jc["kv"].block_table)

    for backend in ("gather", "kernel"):
        ts = AdaptiveServer(tcfg, tp, teng, ServingConfig(
            paged_backend=backend, **scfg), device="cpu")
        tc = T.init_paged_caches(tcfg, B, slots, kv_bits=kv_bits,
                                 block_size=bs, pool_blocks=nb, device="cpu")
        tok = torch.zeros((B,), dtype=torch.int32)
        pos = torch.zeros((B,), dtype=torch.int32)
        tok0, raw = ts.admit_paged(2, prompts, plen, sidx, dest, tok, pos,
                                   tc)
        assert raw is None                        # no masters without a cache
        assert tok0.numpy()[:3].tolist() == ref["tok0"].tolist()
        rem = remaining.copy()
        for s, want in zip(sched, ref["ys"]):
            ys, ok, tok, pos, tc = ts.segment(s, tok, pos, tc, rem)
            assert ys.numpy().tolist() == want.tolist(), backend
            assert bool(ok.all())
            rem = np.maximum(rem - len(s), 0)
        assert np.array_equal(tc["kv"].block_table.numpy(), ref["bt"])
        assert pos.numpy().tolist() == np.asarray(jpos).tolist()
