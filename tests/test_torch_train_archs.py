"""Training through every architecture of the registry against the JAX
reference: the counterpart of the training half of
``tests/test_models.py::test_arch_smoke_train_and_decode`` for all ten
``ARCHS``, on their smoke configs with the reference's weights
(``params_from_jax``), at profile 2 (A8-W8, whose grids both packages
build exactly) and f32.

``train_loss`` (the total, its ``xent`` and its ``aux``) is held within
``1e-5`` of the reference's and the gradient of every parameter leaf
within ``1e-4`` of that leaf's max-abs (``jax.value_and_grad``, jitted; the
f32 contractions run in another order than XLA's). The inputs are the
reference test's kinds: tokens, audio frames with frame targets (hubert),
a vision prefix whose labels are ``-100`` (qwen2-vl); MoE stacks carry the
aux loss, the SSM and hybrid stacks the SSD blocks. Each case also
checks that the gradient is finite and not zero, as the reference test
does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_smoke as jax_get_smoke
from repro.core.profiles import paper_profiles
from repro.models import transformer as JT
from repro_torch.configs import get_smoke
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.profiles import paper_profiles as port_profiles
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.train.loop import _flatten, value_and_grad
from torch_threads import _one_thread  # noqa: F401

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PROFILE = 2
B, S = 2, 32


def _batch(cfg, seed=0):
    """The reference test's batch kinds, drawn with numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal(
                    (B, S, cfg.feature_dim)).astype(np.float32),
                "labels": labels}
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.frontend == "vision":
        labels[:, :cfg.n_patches] = -100
        return {"tokens": tokens, "labels": labels,
                "patch_embeds": rng.standard_normal(
                    (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    return {"tokens": tokens, "labels": labels}


def _bits_row(cfg):
    names = JT.quant_layer_names(cfg)
    inner = [n for n in names if n.startswith("L1.")]
    from repro.core.profiles import profile_table
    return profile_table(paper_profiles(names, inner_layers=inner),
                         names)[PROFILE]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch):
    jcfg, cfg = jax_get_smoke(arch), get_smoke(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    br = _bits_row(jcfg)

    def jloss(p, b):
        return JT.train_loss(p, jcfg, br, b)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))

    names = T.quant_layer_names(cfg)
    engine = AdaptiveEngine(
        tuple(port_profiles(names, inner_layers=[n for n in names
                                                 if n.startswith("L1.")])),
        QuantIndex(names), lambda p, r, b: T.train_loss(p, cfg, r, b))
    assert np.array_equal(engine.bits_row(PROFILE), br)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tl, tm), tg = value_and_grad(
        lambda p, b: engine(p, PROFILE, b), tp, tb)

    for got, want in ((tl, jl), (tm["xent"], jm["xent"]),
                      (tm["aux"], jm["aux"])):
        assert abs(float(got) - float(want)) <= LOSS_TOL, (got, want)
    if cfg.family == "moe":
        assert float(tm["aux"]) > 0
    want_leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(jg)]
    got_leaves, _ = _flatten(tg)
    assert len(got_leaves) == len(want_leaves)
    gnorm = 0.0
    for got, want in zip(got_leaves, want_leaves):
        got = got.numpy()
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= GRAD_TOL * scale
        gnorm += float(np.square(got).sum())
    assert gnorm > 0
