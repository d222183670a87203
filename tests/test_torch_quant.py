"""Quantizers of the PyTorch port against the JAX reference and an exact
numpy model: int4 packing, the KV quantizer, both rounding rules, the
dynamic fake-quant grids (bits 2-8, 16, and the >= 17 passthrough), and
the straight-through gradients of the three fake-quants against
``jax.grad`` of the reference's ``custom_vjp``s.

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
from torch_threads import _one_thread  # noqa: F401

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


def test_ste_gradient_mask():
    """The reference's ``tests/test_quantizers.py::test_ste_gradient_mask``
    on the port, and bitwise against ``jax.grad``."""
    x = np.asarray([-100.0, -0.5, 0.0, 0.5, 100.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    QZ.fake_quant(xt, Q.QuantSpec(bits=8), torch.tensor(0.01)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), [0, 1, 1, 1, 0], atol=1e-6)
    want = jax.grad(lambda v: JQZ.fake_quant(v, JQ.QuantSpec(bits=8),
                                             jnp.asarray(0.01)).sum())(
        jnp.asarray(x))
    assert np.array_equal(xt.grad.numpy(), np.asarray(want))


def _edge_input(bits: int, shape, seed: int, per_token: bool = False):
    """Random values plus elements at and just past the top of each grid's
    clip band (``qmax·s``), so the masks have zeros and edge ones. The
    scales stay near 2^0, where JAX's CPU ``exp2`` is exact, and ``amax``
    stays off ``2^(b−1)·s`` (``qmin·s``), where JAX's ``log2`` may pick the
    next grid. At 16 bits JAX's band itself is off (its ``exp2(15)`` is
    32767.984375, so its ``qmax`` is not 32767): no edge elements there."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * (1000.0 if bits >= 12 else 1.3)
         ).astype(np.float32)
    if bits >= 12:
        return x
    rows = x.reshape(-1, shape[-1]) if per_token else x.reshape(1, -1)
    for r in rows:
        amax = np.float32(np.abs(r).max())
        e = int(np.ceil(np.log2(amax / np.float32(2 ** (bits - 1)))))
        s = np.ldexp(np.float32(1), e)
        qmax = np.float32(2 ** (bits - 1) - 1)
        r[:4] = [qmax * s, -qmax * s, np.nextafter(qmax * s, 2 * amax),
                 -np.nextafter(qmax * s, 2 * amax)]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8, 16, 17])
@pytest.mark.parametrize("kind", ["dynamic", "token"])
def test_ste_dynamic_grad_bitwise_vs_jax(kind, bits, dtype):
    """``fake_quant_dynamic`` (K5's function) and its per-token variant:
    the gradient ``g · [qmin·s <= x <= qmax·s]`` (in f32, passthrough at
    ``bits >= 17``) equals ``jax.grad`` of the reference bit for bit, in
    f32 and bf16."""
    x = _edge_input(bits, (6, 40), bits, per_token=kind == "token")
    g = np.random.default_rng(bits + 1).standard_normal(x.shape).astype(
        np.float32)
    fn, jfn = ((QZ.fake_quant_dynamic, JQZ.fake_quant_dynamic)
               if kind == "dynamic" else
               (QZ.fake_quant_dynamic_token, JQZ.fake_quant_dynamic_token))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = fn(xt, bits, SIGNED_SYM)
    (y * torch.from_numpy(g).to(tdt)).sum().backward()
    jdt = getattr(jnp, dtype)
    want = jax.grad(lambda v: (jfn(v, jnp.int32(bits), SIGNED_SYM)
                               * jnp.asarray(g, jdt)).sum())(
        jnp.asarray(x, jdt))
    got = xt.grad.float().numpy()
    assert np.array_equal(got, np.asarray(want, np.float32))
    if bits < 12 and dtype == "float32":   # bf16 rounds the edges inward
        assert (got == 0).any() and (got != 0).any()
    with torch.no_grad():
        assert torch.equal(y.detach(), fn(xt.detach(), bits))
    if bits == 16:                # the port's band is exact: qmax·s passes
        xe = x.copy()
        xe.flat[0] = np.float32(32767) * np.ldexp(np.float32(1), int(np.ceil(
            np.log2(np.abs(x).max() / np.float32(32768)))))
        xe = torch.from_numpy(xe).requires_grad_(True)
        fn(xe, 16).sum().backward()
        assert xe.grad.flatten()[0] == 1


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits,po2", [(8, True), (4, True), (6, False)])
def test_ste_fake_quant_grad_bitwise_vs_jax(bits, po2, per_channel):
    """The static-spec ``fake_quant`` with its calibrated scale (per tensor
    or per channel) and with a given scale: ``jax.grad`` bit for bit."""
    x = _edge_input(bits, (5, 12), 3 * bits + po2)
    g = np.random.default_rng(bits).standard_normal(x.shape).astype(
        np.float32)
    spec = Q.QuantSpec(bits=bits, po2_scale=po2, per_channel=per_channel)
    jspec = JQ.QuantSpec(bits=bits, po2_scale=po2, per_channel=per_channel)
    for scale in (None, 0.02):
        xt = torch.from_numpy(x).requires_grad_(True)
        s = None if scale is None else torch.tensor(scale)
        (QZ.fake_quant(xt, spec, s) * torch.from_numpy(g)).sum().backward()
        js = None if scale is None else jnp.asarray(scale)
        want = jax.grad(lambda v: (JQZ.fake_quant(v, jspec, js)
                                   * jnp.asarray(g)).sum())(jnp.asarray(x))
        assert np.array_equal(xt.grad.numpy(), np.asarray(want))
        assert (xt.grad == 0).any()


def test_ste_only_where_autograd_records():
    """Inference calls (no grad mode, or an input that needs none) run the
    forward alone and record no graph; a training call goes through the
    straight-through ``Function`` with the same values."""
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    for fn in (lambda t: QZ.fake_quant_dynamic(t, 8),
               lambda t: QZ.fake_quant_dynamic_token(t, 4),
               lambda t: QZ.fake_quant(t, Q.QuantSpec(bits=8))):
        plain = fn(x)
        assert plain.grad_fn is None
        xr = x.clone().requires_grad_(True)
        with torch.no_grad():
            assert fn(xr).grad_fn is None
        y = fn(xr)
        assert type(y.grad_fn).__name__ == "_StraightThroughBackward"
        assert torch.equal(y.detach(), plain)
    assert QZ.fake_quant_dynamic(x.requires_grad_(True), 17) is x
