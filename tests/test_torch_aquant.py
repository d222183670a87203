"""The port's per-tensor dynamic fake-quant (K5's plain version ``aquant_ref``
and the CPU ``fake_quant_dynamic`` that dispatches to it) against the JAX
reference's ``aquant_pallas`` in interpret mode.

Bit for bit on the grid of ``tests/test_kernels.py`` (scales 2^-4..2^0,
where JAX's CPU ``exp2`` is exact). Where its ``exp2`` is not exact
(exponents with |k| >= 13, the logged A16 quirk), within one grid step of
the port's exact power-of-two scale.

The fused cast (``out_dtype``): bf16 out of an f32 ``x`` is bitwise the
reference's ``aquant_pallas(x).astype(bfloat16)``, signed zeros included;
under autograd the value and the gradient are the unfused call's; refused
pairs raise. The kernel's launch plan (``aquant.plan``) covers every element
exactly once around the grid's on-chip store. At the model level, with the
callers asking for bf16: ``moe_ffn``'s routed images equal the reference's
``_qmat`` and its output the unfused port's, and the prequant images equal
the reference's ``fq(w).astype(bfloat16)``, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.profiles import paper_profiles
from repro.kernels.aquant import aquant_pallas
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.runtime import use_compute_dtype as jax_compute_dtype
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.core.quantizers import fake_quant_dynamic
from repro_torch.kernels import aquant as AQ
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import use_compute_dtype
from torch_threads import _one_thread  # noqa: F401

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
    """Off the CPU the wrapper validates before any build or launch; a
    ``meta`` tensor that passes takes the plain version (shape arithmetic
    for the dry run) and counts no launch."""
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="2..16"):
        AQ.aquant(x, 17)
    with pytest.raises(ValueError, match="f32 or bf16"):
        AQ.aquant(x.half(), 8)
    with pytest.raises(ValueError, match="bf16 from f32"):
        AQ.aquant(x.bfloat16(), 8, out_dtype=torch.float32)
    launches = AQ.aquant.launches
    y = AQ.aquant(x, 8, out_dtype=torch.bfloat16)
    assert (y.device.type, y.shape, y.dtype) == ("meta", x.shape,
                                                 torch.bfloat16)
    assert AQ.aquant.launches == launches


def test_operand_check_refuses_a_device_that_is_not_cuda():
    """The kernels' shared operand check refuses any device but the one a
    wrapper holds the call to: CUDA unless the call is a meta one."""
    from repro_torch.kernels.build import check, target
    x, xc = torch.zeros(4, 8, device="meta"), torch.zeros(4, 8)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        check(x, "x", torch.float32, (4, 8))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        check(xc, "x", torch.float32, (4, 8))
    assert target(x) == "meta" and target(xc) == "cuda"
    check(x, "x", torch.float32, (4, 8), target(x))
    with pytest.raises(ValueError, match="must be a meta tensor"):
        check(xc, "x", torch.float32, (4, 8), target(x))
    with pytest.raises(ValueError, match="must have shape"):
        check(x, "x", torch.float32, (8, 4), target(x))


@pytest.mark.parametrize("bits,po2", [(8, True), (4, True), (16, True),
                                      (8, False), (2, True)])
def test_aquant_return_scale_is_the_grid(bits, po2):
    """``return_scale`` hands back the 0-d f32 scale of the grid: the
    output is the plain call's bit for bit and lies on multiples of it,
    and it equals the reference's ``compute_scale`` (po2 scales here are
    2^-6..2^1, where JAX's CPU ``exp2`` is exact)."""
    from repro.core.qtypes import QuantSpec, compute_scale
    x = _x(40, 24, mult=3000.0 if bits == 16 else 0.9)
    y, s = AQ.aquant(torch.from_numpy(x), bits, po2, return_scale=True)
    assert s.shape == () and s.dtype == torch.float32
    assert torch.equal(y, AQ.aquant(torch.from_numpy(x), bits, po2))
    y2, s2 = AQ.aquant_ref(torch.from_numpy(x), bits, po2, return_scale=True)
    assert torch.equal(y2, y) and torch.equal(s2, s)
    q = y.double() / s.double()
    assert float((q - torch.round(q)).abs().max()) <= (0 if po2 else 1e-4)
    want = np.asarray(compute_scale(jnp.asarray(x),
                                    QuantSpec(bits=bits, po2_scale=po2)))
    assert np.array_equal(np.float32(s.item()), want.reshape(()))


# ------------------------------------------------------- the fused cast

F32, BF16 = torch.float32, torch.bfloat16


def _i16(t) -> np.ndarray:
    """bf16 values as their bits (torch or JAX)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("po2", [True, False])
def test_aquant_bf16_out_is_the_reference_cast(bits, po2):
    """bf16 out of f32 rounds ``q·scale`` once: the reference's
    ``aquant_pallas(x).astype(bfloat16)`` bit for bit, on the grid where
    JAX's ``exp2`` is exact; small negatives keep their -0.0."""
    x = _x(128, 96)
    x[0, :8] = -np.float32(1e-4)            # round to -0.0
    want = _i16(aquant_pallas(jnp.asarray(x), bits=bits, po2=po2,
                              block_rows=64,
                              interpret=True).astype(jnp.bfloat16))
    assert (want == np.int16(-32768)).any()
    xt = torch.from_numpy(x)
    for got in (AQ.aquant_ref(xt, bits, po2, out_dtype=BF16),
                AQ.aquant(xt, bits, po2, out_dtype=BF16),
                AQ.aquant_ref(xt, bits, po2).to(BF16)):
        assert got.dtype == BF16 and got.shape == xt.shape
        np.testing.assert_array_equal(_i16(got), want)
    if po2:
        np.testing.assert_array_equal(
            _i16(fake_quant_dynamic(xt, bits, SIGNED_SYM, out_dtype=BF16)),
            want)


@pytest.mark.parametrize("bits", [8, 4, 17])
@pytest.mark.parametrize("xdtype,out_dtype", [(F32, BF16), (BF16, BF16),
                                              (F32, F32)])
def test_fake_quant_dynamic_fused_cast_under_autograd(bits, xdtype,
                                                      out_dtype):
    """Under autograd the fused call gives the unfused
    ``fake_quant_dynamic(x).to(out_dtype)``'s value and gradient (in
    ``x``'s type), the clip band's zeros included (bits 17: the float
    passthrough, cast)."""
    rng = np.random.default_rng(bits)
    x0 = torch.from_numpy(_x(40, 24, mult=1.0)).to(xdtype)
    x0[0, 0] = 7.96875             # above qmax · scale at bits 8 and 4
    g = torch.from_numpy(rng.standard_normal((40, 24)).astype(
        np.float32)).to(out_dtype)
    vals, grads = [], []
    for fused in (True, False):
        x = x0.clone().requires_grad_(True)
        y = (fake_quant_dynamic(x, bits, SIGNED_SYM, out_dtype=out_dtype)
             if fused else
             fake_quant_dynamic(x, bits, SIGNED_SYM).to(out_dtype))
        (y.float() * g.float()).sum().backward()
        vals.append(y.detach())
        grads.append(x.grad)
    assert vals[0].dtype == out_dtype and grads[0].dtype == xdtype
    assert torch.equal(vals[0], vals[1]) and torch.equal(grads[0], grads[1])
    if bits < 17:                  # the clipped value passes no gradient
        assert grads[0][0, 0] == 0 and (grads[0] != 0).sum() > 900


@pytest.mark.parametrize("xdtype,out_dtype", [
    (BF16, F32), (F32, torch.float16), (torch.float16, BF16),
    (BF16, torch.float16)])
def test_refused_dtype_pairs_raise(xdtype, out_dtype):
    """Only x's own type, or bf16 from f32: bf16 → f32 would round twice
    against the plain version's cast chain. Refused on the CPU (plain
    version) and off it, before any build or launch."""
    x = torch.ones(4, 8, dtype=xdtype)
    with pytest.raises(ValueError, match="bf16 from f32"):
        AQ.aquant_ref(x, 8, out_dtype=out_dtype)
    with pytest.raises(ValueError, match="bf16 from f32"):
        AQ.aquant(x, 8, out_dtype=out_dtype)
    with pytest.raises(ValueError, match="bf16 from f32"):
        fake_quant_dynamic(x, 8, SIGNED_SYM, out_dtype=out_dtype)
    if xdtype in (F32, BF16):
        with pytest.raises(ValueError, match="bf16 from f32"):
            AQ.aquant(x.to("meta"), 8, out_dtype=out_dtype)


# ------------------------------------------------------ the launch plan

def _coverage(p: "AQ.Plan") -> np.ndarray:
    """How often the kernel touches each vector of the body under plan
    ``p``: block b's shared-memory part, its register part (vector
    ``rs + r·THREADS + tid`` in ``reg[r]``) and the streamed tiles."""
    counts = np.zeros(p.n_vec, np.int32)
    kb = p.keep_smem + p.keep_reg
    lanes = (np.arange(AQ.REG_VECS // AQ.THREADS)[:, None] * AQ.THREADS
             + np.arange(AQ.THREADS)[None, :]).reshape(-1)
    for b in range(p.grid):
        s = min(b * kb, p.n_vec)
        rs = min(s + p.keep_smem, p.n_vec)
        re = min(rs + p.keep_reg, p.n_vec)
        counts[s:rs] += 1
        idx = rs + lanes
        counts[idx[idx < re]] += 1
    s0 = min(p.grid * kb, p.n_vec)
    for t in range(p.n_tiles):
        counts[s0 + t * AQ.TILE:s0 + (t + 1) * AQ.TILE] += 1
    return counts


_GEOM = {"h100": (132, 2, 112 * 1024), "tiny": (3, 1, 4096)}


@pytest.mark.parametrize("elt", [4, 2])
@pytest.mark.parametrize("geom", list(_GEOM))
@pytest.mark.parametrize("where", ["1", "ve-1", "odd", "store-1", "store",
                                   "store+1", "store+odd", "2x store"])
@pytest.mark.parametrize("offset", [0, 1])
def test_plan_covers_every_element_once(elt, geom, where, offset):
    """``plan`` covers the head, every vector of the body and the tail
    exactly once, keeps no more than the shared memory it is given (and
    the registers' share), never more blocks than fit, and streams tiles
    only above the grid's on-chip store."""
    sm, bps, smem = _GEOM[geom]
    ve = AQ.VEC_BYTES // elt
    store = sm * bps * (smem // AQ.VEC_BYTES + AQ.REG_VECS) * ve
    n = {"1": 1, "ve-1": ve - 1, "odd": 100003, "store-1": store - 1,
         "store": store, "store+1": store + 1, "store+odd": store + 7 * ve + 3,
         "2x store": 2 * store + 5}[where]
    p = AQ.plan(n, elt, sm, bps, smem, offset)
    assert p.head == min(n, (-offset) % ve) and 0 <= p.tail < ve
    assert p.head + p.n_vec * ve + p.tail == n
    assert 1 <= p.grid <= sm * bps
    assert (p.grid == 1) == (p.n_vec <= AQ.THREADS)    # a lone block
    assert p.keep_smem * AQ.VEC_BYTES <= smem and p.keep_reg <= AQ.REG_VECS
    assert p.keep_reg == 0 or p.keep_smem * AQ.VEC_BYTES == smem // 16 * 16
    np.testing.assert_array_equal(_coverage(p), 1)
    on_chip = p.n_vec <= p.grid * (p.keep_smem + p.keep_reg)
    assert on_chip == (p.n_tiles == 0)
    assert on_chip == (n - p.head - p.tail <= store)


# --------------------------------------------- the callers ask for bf16

_MODEL: dict = {}


def _model(arch):
    """``(cfg, tcfg, jp, tp, table)`` of an arch's smoke config on the
    reference's weights, built once."""
    if arch not in _MODEL:
        cfg = get_smoke(arch)
        jp = jax.jit(JT.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        names = JT.quant_layer_names(cfg)
        table = TE.AdaptiveEngine(
            tuple(TP.paper_profiles(names, inner_layers=[])),
            TE.QuantIndex(names)).table
        jtable = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                                QuantIndex(names), lambda *a: None).table
        assert np.array_equal(np.asarray(jtable), np.asarray(table))
        _MODEL[arch] = (cfg, C.get_smoke(arch), jp, tp, table)
    return _MODEL[arch]


def _unfused(monkeypatch, module):
    """``module.fake_quant_dynamic`` without the fused cast: the call,
    then ``.to(out_dtype)``."""
    orig = module.fake_quant_dynamic

    def fq(x, bits, signed_sym=None, out_dtype=None):
        y = orig(x, bits, signed_sym)
        return y if out_dtype is None else y.to(out_dtype)
    monkeypatch.setattr(module, "fake_quant_dynamic", fq)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("xdtype", [F32, BF16])
def test_moe_ffn_with_the_fused_cast(bits, xdtype, monkeypatch):
    """At bf16 compute the routed stacks' images are the reference's
    ``_qmat`` (``fq(w).astype(bfloat16)``) bit for bit, and ``moe_ffn``'s
    output (f32 or bf16 tokens) the unfused port's."""
    cfg, tcfg, jp, tp, _ = _model("qwen2-moe-a2.7b")
    jmoe = {k: v[0] for k, v in jp["layers"]["moe"].items()
            if k in ("w_in", "w_out")}
    tmoe = {k: (v[0] if isinstance(v, torch.Tensor) else
                jax.tree.map(lambda a: a[0], v))
            for k, v in tp["layers"]["moe"].items()}
    bw = np.array([bits, bits], np.int32)
    with use_compute_dtype(BF16), jax_compute_dtype(jnp.bfloat16):
        for name in ("w_in", "w_out"):
            got = M._qmat(tmoe[name], bw, BF16)
            want = JM._qmat(jmoe[name], jnp.asarray(bw))
            assert got.dtype == BF16
            np.testing.assert_array_equal(_i16(got), _i16(want))
        rng = np.random.default_rng(bits)
        x = torch.from_numpy(rng.standard_normal((4, 6, 64)).astype(
            np.float32)).to(xdtype)
        bd = {site: bw for site in M.MOE_SITES}
        mcfg = M.MoEConfig(**dataclasses.asdict(tcfg.moe))
        y, aux = M.moe_ffn(tmoe, x, bd, mcfg)
        _unfused(monkeypatch, M)
        y2, aux2 = M.moe_ffn(tmoe, x, bd, mcfg)
    assert torch.equal(y, y2)
    assert all(torch.equal(aux[k], aux2[k]) for k in aux)


def _leaves(mine, ref, path=()):
    """Pairs (path, port tensor, reference array) of the ``wfq`` images
    both overlay trees hold."""
    for k, v in mine.items():
        if k not in ref:
            continue
        if isinstance(v, dict):
            yield from _leaves(v, ref[k], path + (k,))
        elif k == "wfq":
            yield path, v, ref[k]


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_prequant_images_with_the_fused_cast(arch, monkeypatch):
    """``prequant_decode_weights`` at bf16: every image the reference's
    ``fq(w)`` cast to bf16, bit for bit, and the unfused port's."""
    cfg, tcfg, jp, tp, table = _model(arch)
    mine = T.prequant_decode_weights(tp, tcfg, table, dtype=BF16)
    ref = jax.jit(JT.prequant_decode_weights, static_argnums=1)(
        jp, cfg, jnp.asarray(table))
    _unfused(monkeypatch, T)
    unfused = T.prequant_decode_weights(tp, tcfg, table, dtype=BF16)
    n = 0
    for p in range(len(mine)):
        for path, got, want in _leaves(mine[p], ref):
            assert got.dtype == BF16, path
            np.testing.assert_array_equal(
                _i16(got), _i16(jnp.asarray(want)[p].astype(jnp.bfloat16)),
                err_msg=str(path))
            other = unfused[p]
            for k in path + ("wfq",):
                other = other[k]
            assert torch.equal(got.view(torch.int16),
                               other.view(torch.int16)), path
            n += 1
    assert n >= 4 * len(mine)
