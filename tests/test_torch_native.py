"""The port's native integer-weight path against the JAX reference (smoke
granite-3-2b, CPU):

* ``quantize_native`` / ``dequantize``: int grids, scales and dequantized
  values bit for bit (int8 and packed int4; per-channel float scales and
  per-tensor po2 scales);
* ``to_native``: structure, bits and every carrier bit for bit at W8/W4,
  and ``params_from_jax`` carrying the reference's ``QTensor`` leaves;
* the native ``qlinear``: at f32 compute within 1e-5 (the same f32 matmul
  of the same dequantized weight, summed in another order); at bf16 compute
  (``use_compute_dtype`` on both sides) within one bf16 rounding of the
  output, ``rtol`` 2^-7 (the f32 sums differ in order, then both round to
  bf16);
* native ``prefill`` logits within 1e-4 of JAX's for every paper profile
  (f32 on both sides; the A16 profiles carry the reference's inexact pow2
  activation scale);
* the ``ContinuousScheduler`` serving ``to_native`` params: tokens, profile
  traces, billing events and admission order equal to the JAX scheduler's
  at kv16 and kv8, W8 and W4, with both of the port's paged backends.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.profiles import paper_profiles
from repro.core.qtypes import QuantSpec as JSpec
from repro.core.quantizers import QTensor as JQTensor
from repro.core.quantizers import dequantize as jax_dequantize
from repro.core.quantizers import quantize_native as jax_quantize_native
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.native import to_native as jax_to_native
from repro.serving.engine import AdaptiveServer as JServer
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingConfig as JConfig
from repro.serving.scheduler import ContinuousScheduler as JScheduler
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.qtypes import QuantSpec
from repro_torch.core.quantizers import QTensor, dequantize, quantize_native
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import NATIVE_SITES, to_native
from repro_torch.runtime import use_compute_dtype
from repro_torch.serving.engine import AdaptiveServer, Request, ServingConfig
from repro_torch.serving.scheduler import ContinuousScheduler

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
    return cfg, C.get_smoke("granite-3-2b"), jp, tp, jeng, teng


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp_bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _sites(tree, path=()):
    """(path, QTensor) for every native site of a port tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "wq":
                yield path, v
            else:
                yield from _sites(v, path + (k,))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["per_channel", "per_tensor_po2"])
def test_quantize_native_and_dequantize_bitwise(bits, kind):
    rng = np.random.default_rng(bits)
    w = (rng.standard_normal((48, 96)) * 0.1).astype(np.float32)
    w[3, 7] = 0.0                                  # exact zero
    kw = (dict(per_channel=True, channel_axis=-1, po2_scale=False)
          if kind == "per_channel" else dict(po2_scale=True))
    jqt = jax_quantize_native(jnp.asarray(w), JSpec(bits=bits, **kw))
    qt = quantize_native(torch.from_numpy(w), QuantSpec(bits=bits, **kw))
    assert (qt.bits, qt.orig_last, qt.shape) == (bits, 96, (48, 96))
    assert qt.data.dtype == torch.int8
    assert qt.data.shape == (48, 96 // 2 if bits <= 4 else 96)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(_np(dequantize(qt, tdt)),
                                      _jnp_bits(jax_dequantize(jqt, jdt)))


@pytest.mark.parametrize("w_bits", [8, 4])
def test_to_native_structure_and_carriers(parts, w_bits):
    cfg, tcfg, jp, tp, _, _ = parts
    jn = jax_to_native(jp, w_bits)
    tn = to_native(tp, w_bits)
    qkv = tn["layers"]["qkv"]["wq"]
    assert isinstance(qkv, QTensor) and "w" not in tn["layers"]["qkv"]
    assert "g" in tn["layers"]["norm_attn"]         # norms stay float
    assert tn["layers"]["norm_attn"]["g"] is tp["layers"]["norm_attn"]["g"]
    assert qkv.data.shape[0] == qkv.scale.shape[0] == cfg.n_layers
    assert qkv.scale.shape[1] == 1                  # per-layer [L, 1, N]
    if w_bits == 4:
        assert qkv.data.shape[-1] == tp["layers"]["qkv"]["w"].shape[-1] // 2
    want = dict(_sites(params_from_jax(jax.tree.map(np.asarray, jn),
                                       device="cpu")))
    got = dict(_sites(tn))
    assert sorted(got) == sorted(want) and len(got) == 5   # 4 linears + embed
    assert {p[-1] for p in got} <= set(NATIVE_SITES)
    for path, qt in got.items():
        w = want[path]
        assert (qt.bits, qt.orig_last) == (w.bits, w.orig_last) == \
            (w_bits, qt.shape[-1])
        assert torch.equal(qt.data, w.data), path
        assert torch.equal(qt.scale, w.scale), path
    # param_count sees the carriers' tensors, as the reference's leaves
    assert T.param_count(tn) == JT.param_count(jn)


def test_params_from_jax_carries_native_leaves(parts):
    _, _, jp, _, _, _ = parts
    jn = jax_to_native(jp, 4)
    assert isinstance(jn["embed"]["wq"], JQTensor)
    tn = params_from_jax(jax.tree.map(np.asarray, jn), device="cpu")
    qt = tn["embed"]["wq"]
    assert isinstance(qt, QTensor)
    assert type(qt.bits) is int and type(qt.orig_last) is int
    assert (qt.bits, qt.orig_last) == (4, jp["embed"]["w"].shape[-1])
    np.testing.assert_array_equal(qt.data.numpy(),
                                  np.asarray(jn["embed"]["wq"].data))
    np.testing.assert_array_equal(tn["layers"]["norm_mlp"]["g"].numpy(),
                                  np.asarray(jp["layers"]["norm_mlp"]["g"]))


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("a_bits", [8, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_native_qlinear_matches_reference(w_bits, a_bits, bf16):
    rng = np.random.default_rng(w_bits + a_bits)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    b = (rng.standard_normal((96,)) * 0.1).astype(np.float32)
    # |x| up to ~80: the A16 activation scale stays at 2^-9, where JAX's
    # exp2 is exact (the logged A16 quirk is covered by the prefill test)
    x = (rng.standard_normal((2, 5, 64)) * 20).astype(np.float32)
    jlin = JL.quantize_linear_native({"w": jnp.asarray(w),
                                      "b": jnp.asarray(b)}, w_bits)
    tlin = L.quantize_linear_native({"w": torch.from_numpy(w),
                                     "b": torch.from_numpy(b)}, w_bits)
    assert torch.equal(tlin["wq"].data,
                       torch.from_numpy(np.array(jlin["wq"].data)))
    bits = np.array([a_bits, w_bits], np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    want = np.asarray(JL.qlinear(jlin, jnp.asarray(x), jnp.asarray(bits),
                                 compute_dtype=jdt)).astype(np.float32)
    L.dequant_matmul.calls = 0
    with use_compute_dtype(tdt):
        got = L.qlinear(tlin, torch.from_numpy(x), bits)
    assert got.dtype == tdt
    # bf16 compute takes ops.qmatmul (K3's path), f32 the reference's code
    assert L.dequant_matmul.calls == (0 if bf16 else 1)
    if bf16:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _prompts(vocab: int, bucket: int, rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((rows, bucket), np.int32)
    plen = np.zeros((rows,), np.int32)
    for j, n in enumerate(PLENS):
        prompts[j, bucket - n:] = rng.integers(0, vocab, n)
        plen[j] = n
    return prompts, plen


@pytest.mark.parametrize("w_bits", [8, 4])
def test_native_prefill_logits_every_profile(parts, w_bits):
    cfg, tcfg, jp, tp, jeng, teng = parts
    jn = jax_to_native(jp, w_bits)
    tn = to_native(tp, w_bits)
    prompts, plen = _prompts(cfg.vocab, 32, len(PLENS))
    for pid in range(len(teng.table)):
        jl, _ = JT.prefill(jn, cfg, jnp.asarray(jeng.table)[pid],
                           {"tokens": jnp.asarray(prompts),
                            "prompt_len": jnp.asarray(plen)}, 64)
        tl, _ = T.prefill(tn, tcfg, teng.table[pid],
                          {"tokens": torch.from_numpy(prompts),
                           "prompt_len": plen}, 64)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"profile {pid}")


def test_prequant_passes_native_sites_through(parts):
    """Native linears and the embedding get no image; the tied head gets
    one per distinct head bits (two for the paper profiles), on its grid."""
    _, tcfg, _, tp, _, teng = parts
    tn = to_native(tp, 8)
    ovs = T.prequant_decode_weights(tn, tcfg, teng.table)
    assert all(set(ov) == {"lm_head", "layers"} and not ov["layers"]
               for ov in ovs)
    heads = {ov["lm_head"]["wfq"].data_ptr() for ov in ovs}
    assert len(heads) == 2
    head_bits = T.split_bits(tcfg, teng.table[0])[1][1]
    table = dequantize(tn["embed"]["wq"], torch.float32)
    from repro_torch.core.quantizers import fake_quant_dynamic
    assert torch.equal(ovs[0]["lm_head"]["wfq"],
                       fake_quant_dynamic(table, int(head_bits)).t())


CASES = [(7, 6), (8, 5), (9, 7), (16, 4), (17, 6)]


@pytest.mark.parametrize("kv_bits,w_bits", [(16, 8), (16, 4), (8, 8),
                                            (8, 4)])
def test_native_scheduler_matches_reference(parts, kv_bits, w_bits):
    cfg, tcfg, jp, tp, jeng, teng = parts
    jn = jax_to_native(jp, w_bits)
    tn = to_native(tp, w_bits)
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), m, m == 6)
            for n, m in CASES]
    scfg = dict(slots=64, max_batch=4, kv_bits=kv_bits, block_size=8)
    js = JServer(cfg, jn, jeng, JConfig(prefix_cache=False, **scfg))
    jsched = JScheduler(js, quantum=4)
    for t, m, crit in reqs:
        jsched.submit(JRequest(tokens=t, max_new=m, accuracy_critical=crit))
    want = jsched.run()
    for backend in ("gather", "kernel"):
        ts = AdaptiveServer(tcfg, tn, teng, ServingConfig(
            paged_backend=backend, **scfg), device="cpu")
        sched = ContinuousScheduler(ts, quantum=4)
        for t, m, crit in reqs:
            sched.submit(Request(tokens=t, max_new=m, accuracy_critical=crit))
        got = sched.run()
        for g, w in zip(got, want):
            assert g["tokens"] == w["tokens"], backend
            assert g["profile_trace"] == w["profile_trace"]
            assert g["status"].value == w["status"].value == "completed"
        assert sched.events == jsched.events
        assert sched.admission_log == jsched.admission_log
        assert sched.allocator.used_blocks == 0
