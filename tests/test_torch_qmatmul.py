"""The port's dequant-matmul (K3's plain version, through ``ops.qmatmul``)
against the JAX reference: ``ops.qmatmul`` (the Pallas kernel in interpret
mode) and ``ref.qmatmul_ref``, on the grid of ``tests/test_kernels.py``.

Both sides multiply the same bf16-rounded operands, whose products are
exact in f32, so they differ only in the order of the f32 sums: ``atol``
1e-4 (the reference's own kernel-vs-oracle tolerance) at these widths
(K <= 512, |sum| of a few units). The fused requant lands on the same grid
(``atol`` 1e-5, as the reference tests it). Gradients to x: ``atol`` 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantSpec, quantize_native
from repro.kernels import ref
from repro.kernels.ops import qmatmul_qt as jax_qmatmul_qt
from repro_torch.core.quantizers import QTensor
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _qt(jqt) -> QTensor:
    return QTensor(_t(jqt.data), _t(jqt.scale), jqt.bits, jqt.orig_last)


def _case(m, k, n, bits, spec=None, seed=None):
    key = jax.random.PRNGKey(m * 1000 + n + bits if seed is None else seed)
    kx, kw = jax.random.split(key)
    x = jax.random.normal(kx, (m, k), jnp.float32)
    w = jax.random.normal(kw, (k, n), jnp.float32) * 0.1
    spec = spec or QuantSpec(bits=bits, per_channel=True, channel_axis=-1,
                             po2_scale=False)
    return x, quantize_native(w, spec)


@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (64, 256, 384),
                                   (5, 100, 70), (1, 512, 256), (33, 96, 40)])
@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_matches_reference(m, k, n, bits):
    x, jqt = _case(m, k, n, bits)
    scale = jnp.asarray(jqt.scale, jnp.float32).reshape(-1)
    want_ref = np.asarray(ref.qmatmul_ref(x, jqt.data, scale, bits))
    want_pallas = np.asarray(jax_qmatmul_qt(x, jqt))
    got = ops.qmatmul_qt(_t(x), _qt(jqt))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-4, rtol=0)
    # the kernel wrapper's CPU branch is the plain version itself
    assert torch.equal(K.qmatmul(_t(x), _t(jqt.data), _t(scale), bits=bits),
                       K.qmatmul_ref(_t(x), _t(jqt.data), _t(scale), bits))


@pytest.mark.parametrize("xdtype", [jnp.float32, jnp.bfloat16])
def test_qmatmul_dtypes_and_scalar_scale(xdtype):
    """x in f32 or bf16; a per-tensor (scalar, po2) scale broadcasts."""
    key = jax.random.PRNGKey(7)
    x = jax.random.normal(key, (16, 128), jnp.float32).astype(xdtype)
    w = jax.random.normal(jax.random.fold_in(key, 1), (128, 128)) * 0.1
    jqt = quantize_native(w, QuantSpec(bits=8))
    assert np.asarray(jqt.scale).ndim == 0
    want = np.asarray(jax_qmatmul_qt(x, jqt))
    got = ops.qmatmul_qt(_t(x), _qt(jqt))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_qmatmul_fused_requant():
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(key, (16, 128))
    w = jax.random.normal(jax.random.fold_in(key, 2), (128, 128)) * 0.1
    jqt = quantize_native(w, QuantSpec(bits=8))
    scale = jnp.asarray(jqt.scale).reshape(-1)
    for out_bits, out_scale in [(8, 0.25), (4, 0.5)]:
        want = np.asarray(ref.qmatmul_ref(x, jqt.data, scale, 8,
                                          out_scale=out_scale,
                                          out_bits=out_bits))
        got = ops.qmatmul_qt(_t(x), _qt(jqt), out_bits=out_bits,
                             out_scale=out_scale).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        q = got / out_scale                       # on the fixed-point grid
        np.testing.assert_array_equal(q, np.round(q))
        assert q.min() >= -2 ** (out_bits - 1)
        assert q.max() <= 2 ** (out_bits - 1) - 1


@pytest.mark.parametrize("bits", [8, 4])
def test_qmatmul_batched_and_grad(bits):
    """Leading dims flatten to M; dx = g @ dequant(w).T in x's dtype, as the
    reference's custom VJP gives it."""
    key = jax.random.PRNGKey(5)
    x = jax.random.normal(key, (2, 3, 128))
    w = jax.random.normal(jax.random.fold_in(key, 1), (128, 64)) * 0.1
    jqt = quantize_native(w, QuantSpec(bits=bits, per_channel=True,
                                       channel_axis=-1, po2_scale=False))
    gy = jax.random.normal(jax.random.fold_in(key, 2), (2, 3, 64))
    want = np.asarray(jax.grad(
        lambda x_: (jax_qmatmul_qt(x_, jqt) * gy).sum())(x))
    xt = _t(x).requires_grad_(True)
    y = ops.qmatmul_qt(xt, _qt(jqt))
    assert y.shape == (2, 3, 64)
    (y * _t(gy)).sum().backward()
    assert xt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=0)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    """Off the CPU the wrapper validates before any build or launch."""
    x = torch.zeros(4, 32, device="meta")
    w = torch.zeros(32, 16, dtype=torch.int8, device="meta")
    s = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="1..8"):
        K.qmatmul(x, w, s, bits=16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        K.qmatmul(x.half(), w, s)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.qmatmul(x, w, s)
    with pytest.raises(ValueError, match="go together"):
        K.qmatmul(x, w, s, out_bits=8)
