"""The port's per-tensor dynamic fake-quant (K5's plain version ``aquant_ref``
and the CPU ``fake_quant_dynamic`` that dispatches to it) against the JAX
reference's ``aquant_pallas`` in interpret mode.

Bit for bit on the grid of ``tests/test_kernels.py`` (scales 2^-4..2^0,
where JAX's CPU ``exp2`` is exact). Where its ``exp2`` is not exact
(exponents with |k| >= 13, the logged A16 quirk), within one grid step of
the port's exact power-of-two scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.aquant import aquant_pallas
from repro_torch.core.quantizers import fake_quant_dynamic
from repro_torch.kernels import aquant as AQ

SIGNED_SYM = np.array([1, 0], np.int32)


def _x(m, n, mult=3.7):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(m + n), (m, n),
                                        jnp.float32)) * np.float32(mult)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("m,n,bits,po2", [(64, 128, 8, True),
                                          (100, 64, 4, True),
                                          (257, 96, 8, False),
                                          (8, 32, 2, True)])
def test_aquant_bitwise_vs_pallas(m, n, bits, po2):
    x = _x(m, n)
    want = np.asarray(aquant_pallas(jnp.asarray(x), bits=bits, po2=po2,
                                    block_rows=64, interpret=True))
    got = AQ.aquant(torch.from_numpy(x), bits, po2).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.array_equal(AQ.aquant_ref(torch.from_numpy(x), bits,
                                        po2).numpy(), got)
    if po2:                 # fake_quant_dynamic is K5's po2 case, any shape
        fq = fake_quant_dynamic(torch.from_numpy(x.reshape(-1)), bits,
                                SIGNED_SYM).numpy().reshape(m, n)
        np.testing.assert_array_equal(_bits(fq), _bits(want))


@pytest.mark.parametrize("bits", [12, 16])
def test_aquant_within_one_step_where_jax_exp2_is_inexact(bits):
    """amax ~ 0.02 puts the scale near 2^-19..2^-23: JAX's grid there is
    not a power of two, the port's is."""
    x = _x(96, 64, mult=0.005)
    want = np.asarray(aquant_pallas(jnp.asarray(x), bits=bits, po2=True,
                                    interpret=True))
    got = AQ.aquant(torch.from_numpy(x), bits).numpy()
    amax = np.float32(np.abs(x).max())
    step = np.ldexp(np.float32(1), int(np.ceil(np.log2(
        amax / np.float32(2 ** (bits - 1))))))
    assert np.abs(got - want).max() <= step
    assert np.all(got / step == np.round(got / step))   # the port's grid


def test_aquant_idempotent_and_grid():
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0),
                                                    (64, 64))))
    y = AQ.aquant(x, 6)
    assert torch.equal(AQ.aquant(y, 6), y)
    assert len(torch.unique(y)) <= 2 ** 6
    yb = AQ.aquant(x.bfloat16(), 6)            # bf16 in, bf16 out
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb.float(), AQ.aquant_ref(x.bfloat16(), 6).float())


def test_aquant_wrapper_rejects_what_the_kernel_cannot_take():
    """Off the CPU the wrapper validates before any build or launch."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="2..16"):
        AQ.aquant(x, 17)
    with pytest.raises(ValueError, match="f32 or bf16"):
        AQ.aquant(x.half(), 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        AQ.aquant(x, 8)
