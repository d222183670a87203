"""Quantizers of the PyTorch port against the JAX reference and an exact
numpy model: int4 packing, the KV quantizer, both rounding rules, and the
dynamic fake-quant grids (bits 2-8, 16, and the >= 17 passthrough).

The port builds power-of-two scales exactly; the reference's CPU ``exp2`` is
off by up to ~1e-6 relative for integer exponents with |k| >= 13, so against
JAX the fake-quant outputs are compared with ``rtol=2e-6`` and against the
exact numpy model bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qtypes as JQ
from repro.core import quantizers as JQZ
from repro.models import attention as JA
from repro_torch.core import qtypes as Q
from repro_torch.core import quantizers as QZ
from repro_torch.models import attention as A

SIGNED_SYM = np.array([1, 0], np.int32)


def _np_fqd(x: np.ndarray, bits: int, axis=None) -> np.ndarray:
    """Exact model: round half away from zero on a pow2 grid built with
    ``ldexp`` (no exp2 rounding)."""
    xf = x.astype(np.float32)
    if bits >= 17:
        return xf
    qmax = np.float32(2 ** (bits - 1) - 1)
    qmin = np.float32(-(2 ** (bits - 1)))
    amax = np.maximum(np.abs(xf).max(axis=axis, keepdims=axis is not None),
                      np.float32(1e-9)).astype(np.float32)
    e = np.ceil(np.log2(amax / np.float32(2 ** (bits - 1))))
    scale = np.ldexp(np.float32(1.0), e.astype(np.int32)).astype(np.float32)
    v = xf / scale
    q = np.clip(np.sign(v) * np.floor(np.abs(v) + np.float32(0.5)), qmin, qmax)
    return (q * scale).astype(np.float32)


def test_pack_unpack_int4_bit_exact_vs_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (3, 5, 16)).astype(np.int8)
    packed = Q.pack_int4(torch.from_numpy(q))
    assert np.array_equal(packed.numpy(), np.asarray(JQ.pack_int4(jnp.asarray(q))))
    assert np.array_equal(Q.unpack_int4(packed).numpy(), q)
    raw = rng.integers(-128, 128, (4, 7, 6)).astype(np.int8)   # every byte
    assert np.array_equal(Q.unpack_int4(torch.from_numpy(raw)).numpy(),
                          np.asarray(JQ.unpack_int4(jnp.asarray(raw))))


@pytest.mark.parametrize("bits", [8, 4])
def test_kv_quantizer_bit_exact_vs_jax(bits):
    """``_quantize_kv`` rounds half to even (``jnp.round``/``torch.round``),
    including exact ties, and packs kv4 the reference's way."""
    rng = np.random.default_rng(bits)
    scale = rng.uniform(0.01, 0.05, (3, 2)).astype(np.float32)
    q = rng.integers(-7, 8, (3, 5, 2, 8)).astype(np.float32)
    frac = rng.choice(np.float32([0.0, 0.5, -0.5, 0.25, 0.49]), q.shape)
    x = ((q + frac) * scale[:, None, :, None]).astype(np.float32)
    got = A._quantize_kv(torch.from_numpy(x), torch.from_numpy(scale), bits)
    want = JA._quantize_kv(jnp.asarray(x), jnp.asarray(scale), bits)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_rounding_rules_at_ties():
    """Activation/weight fake-quant rounds half away from zero; the KV
    quantizer rounds half to even — each rule where the reference uses it."""
    # amax 16 at 8 bits -> scale 2^-3; entries sit on k + 1/2 of the grid
    x = np.float32([16.0, 0.0625, -0.1875, 0.3125, -0.3125, 0.1875])
    got = QZ.fake_quant_dynamic(torch.from_numpy(x), 8).numpy()
    want = np.float32([15.875, 0.125, -0.25, 0.375, -0.375, 0.25])
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(
        JQZ.fake_quant_dynamic(jnp.asarray(x), jnp.int32(8), SIGNED_SYM)))
    ties = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5]).reshape(1, 5, 1, 1)
    kv = A._quantize_kv(ties, torch.ones(1, 1), 8).flatten().tolist()
    assert kv == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8, 16, 17, 32])
def test_fake_quant_dynamic_vs_exact_and_jax(bits, per_token):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((4, 33)) * rng.uniform(0.01, 20, (4, 1))
         ).astype(np.float32)
    fn, jfn = ((QZ.fake_quant_dynamic_token, JQZ.fake_quant_dynamic_token)
               if per_token else
               (QZ.fake_quant_dynamic, JQZ.fake_quant_dynamic))
    got = fn(torch.from_numpy(x), bits).numpy()
    assert np.array_equal(got, _np_fqd(x, bits, -1 if per_token else None))
    ref = np.asarray(jfn(jnp.asarray(x), jnp.int32(bits), SIGNED_SYM))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=0)
    if bits >= 17:
        assert np.array_equal(got, x)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("po2", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8, 17])
def test_fake_quant_spec_vs_jax(bits, po2, per_channel):
    """Static-spec fake-quant (calibrated scale, per tensor or per channel,
    pow2 or float) equals the reference's forward bit for bit."""
    rng = np.random.default_rng(bits + 2 * po2)
    x = (rng.standard_normal((6, 10)) * rng.uniform(0.1, 3, (1, 10))
         ).astype(np.float32)
    spec = Q.QuantSpec(bits=bits, po2_scale=po2, per_channel=per_channel)
    jspec = JQ.QuantSpec(bits=bits, po2_scale=po2, per_channel=per_channel)
    got = QZ.fake_quant(torch.from_numpy(x), spec).numpy()
    assert np.array_equal(got, np.asarray(JQZ.fake_quant(jnp.asarray(x), jspec)))
    if not spec.is_float:
        assert Q.qrange(spec) == JQ.qrange(jspec)
        scale = Q.compute_scale(torch.from_numpy(x), spec).numpy()
        assert np.array_equal(scale, np.asarray(JQ.compute_scale(jnp.asarray(x), jspec)))


def test_pow2_scale_is_exact_where_jax_exp2_is_not():
    """Pitfall 1: at A16 an amax in (0.5, 1] gives a scale of 2^-15. JAX's
    CPU exp2(-15) is not 2^-15, so its grid is off; the port's is exact."""
    assert float(jnp.exp2(jnp.float32(-15.0))) != 2.0 ** -15
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.75, 0.75, (64,)).astype(np.float32)
    x[0] = 0.75
    got = QZ.fake_quant_dynamic(torch.from_numpy(x), 16).numpy()
    grid = got.astype(np.float64) * 2.0 ** 15
    assert np.array_equal(grid, np.round(grid))           # on the exact grid
    assert np.array_equal(got, _np_fqd(x, 16))
    ref = np.asarray(JQZ.fake_quant_dynamic(jnp.asarray(x), jnp.int32(16),
                                            SIGNED_SYM))
    # the reference's inexact scale moves values near a rounding tie by
    # one step of the grid, never more
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0 ** -15)
    k = np.arange(-149, 128)                      # subnormals to the top
    s = Q.exp2_int(torch.from_numpy(k.astype(np.float32)))
    assert s.dtype == torch.float32
    assert np.array_equal(s.numpy(), np.ldexp(np.float32(1.0), k))


def _jax_prefill_scales(bits: int):
    """The reference's prefill on the smoke model (ragged rows): its int-KV
    scales and the raw K/V they were calibrated on."""
    from repro.configs import get_smoke
    from repro.models import transformer as JT
    cfg = get_smoke("granite-3-2b")
    params = JT.init_params(cfg, jax.random.PRNGKey(bits))
    table = np.ones((2 + 4 * cfg.n_layers, 2), np.int32) * 32
    rng = np.random.default_rng(bits)
    prompts = rng.integers(0, cfg.vocab, (3, 12)).astype(np.int32)
    plen = np.array([12, 7, 3], np.int32)
    batch = {"tokens": jnp.asarray(prompts), "prompt_len": jnp.asarray(plen)}
    _, caches, (rk, rv) = jax.jit(
        lambda p, b: JT.prefill(p, cfg, jnp.asarray(table), b, 16,
                                kv_bits=bits, return_raw_kv=True))(params,
                                                                    batch)
    return (cfg, table, prompts, plen, np.asarray(rk), np.asarray(rv),
            np.asarray(caches["kv"].k_scale), np.asarray(caches["kv"].v_scale))


@pytest.mark.parametrize("site,bits", [("step", 8), ("step", 4),
                                       ("prefill", 8), ("prefill", 4),
                                       ("window", 8)])
def test_kv_scale_matches_jax_bitwise(site, bits, monkeypatch):
    """The int-KV scale ``amax/qmax + 1e-9`` equals the reference's jitted
    function bit for bit at each calibration site — the decode step, the
    prefill, and the speculative window ladder. XLA on the CPU lowers the
    expression to one fused multiply-add, ``fma(amax, f32(1/qmax),
    f32(1e-9))``, which ``attention.kv_scale`` computes; true division is
    one ulp off in most elements. The prefill site runs the port's
    ``prefill`` on the reference's raw K/V (its forward swapped for them)."""
    from repro_torch.models import transformer as T
    qmax = np.float32(127.0 if bits == 8 else 7.0)
    rng = np.random.default_rng(bits + len(site))
    if site == "prefill":
        cfg, table, prompts, plen, rk, rv, jks, jvs = _jax_prefill_scales(bits)
        import repro_torch.configs as C
        tcfg = C.get_smoke("granite-3-2b")
        b, s = prompts.shape

        def raw_forward(params, cfg, bits_row, batch, collect=False,
                        kv_sched=None):
            return (torch.zeros(b, s, cfg.d_model), None,
                    (torch.from_numpy(rk.copy()), torch.from_numpy(rv.copy())))

        monkeypatch.setattr(T, "forward", raw_forward)
        monkeypatch.setattr(T, "_logits", lambda *a: torch.zeros(b, 1, 8))
        _, caches = T.prefill({}, tcfg, table,
                              {"tokens": torch.from_numpy(prompts),
                               "prompt_len": plen}, 16, kv_bits=bits)
        got = (caches["kv"].k_scale.numpy(), caches["kv"].v_scale.numpy())
        want = (jks, jvs)
        amax = np.abs(rk).max(axis=(2, 4))         # unmasked: rows differ
    elif site == "step":
        k = (rng.standard_normal((64, 1, 2, 16))
             * rng.uniform(0.01, 5, (64, 1, 2, 1))).astype(np.float32)
        cache = A.init_kv_cache(64, 4, 2, 16, bits=bits, device="cpu")
        cache.k_scale.fill_(1e-6)
        ks, _, _, _ = A._kv_step_quantize(cache, torch.from_numpy(k),
                                          torch.from_numpy(k))
        jc = JA.init_kv_cache(64, 4, 2, 16, bits=bits)._replace(
            k_scale=jnp.full((64, 2), 1e-6, jnp.float32))
        jks = jax.jit(lambda c, x: JA._kv_step_quantize(c, x, x)[0])(
            jc, jnp.asarray(k))
        got, want = (ks.numpy(),), (np.asarray(jks),)
        amax = np.abs(k).max(axis=(1, 3))
    else:
        k = (rng.standard_normal((16, 5, 2, 16))
             * rng.uniform(0.01, 5, (16, 5, 2, 1))).astype(np.float32)
        cache = A.init_kv_cache(16, 8, 2, 16, bits=bits, device="cpu")
        cache.k_scale.fill_(1e-6)
        lad, _, _, _ = A._kv_window_quantize(cache, torch.from_numpy(k),
                                             torch.from_numpy(k))
        jc = JA.init_kv_cache(16, 8, 2, 16, bits=bits)._replace(
            k_scale=jnp.full((16, 2), 1e-6, jnp.float32))
        jlad = jax.jit(lambda c, x: JA._kv_window_quantize(c, x, x)[0])(
            jc, jnp.asarray(k))
        got, want = (lad.numpy(),), (np.asarray(jlad),)
        amax = np.abs(k).max(axis=3)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), site
    # the fused form, not true division, is what matches
    fma = (amax.astype(np.float64) * np.float64(np.float32(1 / qmax))
           + np.float64(np.float32(1e-9))).astype(np.float32)
    div = (amax / qmax + np.float32(1e-9)).astype(np.float32)
    assert not np.array_equal(fma, div)
