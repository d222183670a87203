"""The port's AdamW (``repro_torch.optim.adam``) and synthetic digits
(``repro_torch.data.digits``) against the JAX reference's: the same
gradients through both optimizers give the same parameters, moments,
learning rates and norms (within 1e-6: both compute in f32, XLA may fuse
an update into one rounding where torch rounds twice), and the digit
renderer, the datasets and the batch iterator are bitwise the
reference's (numpy only on both sides)."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import digits as JD
from repro.optim import adam as JA
from repro_torch.data import digits as D
from repro_torch.optim import adam as A


def _tree(rng):
    return {"conv": {"w": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)},
            "fc": {"w": rng.standard_normal((8, 5)).astype(np.float32)},
            "a": rng.standard_normal(3).astype(np.float32)}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("cfg", [
    dict(lr=1e-2, warmup_steps=3, total_steps=12),
    dict(lr=1e-3, warmup_steps=10, total_steps=120, weight_decay=0.0),
    dict(lr=5e-2, warmup_steps=1, total_steps=6, clip_norm=0.5, b2=0.999)])
def test_adamw_steps_match_reference(cfg):
    """Twelve steps from the same tree on the same gradients (large enough
    that the clip engages): parameters, moments, step, learning rate and
    the pre-clip norm within 1e-6 of the reference's."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jc, tc = JA.AdamConfig(**cfg), A.AdamConfig(**cfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), _torch(tree)
    js, ts = JA.adam_init(jp), A.adam_init(tp)
    for step in range(12):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * (3.0 if step % 3 else 0.1)
                                    ).astype(np.float32), tree)
        jp, js, jm = JA.adam_update(jc, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = A.adam_update(tc, _torch(g), ts, tp)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for want, got in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
            for w, t in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(got)):
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)


def test_warmup_cosine_matches_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = [float(A.warmup_cosine(A.AdamConfig(**cfg), torch.tensor(s)))
           for s in range(101)]
    want = [float(JA.warmup_cosine(JA.AdamConfig(**cfg), jnp.asarray(s)))
            for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and abs(got[10] - 1.0) < 1e-6
    assert abs(got[100] - 0.1) < 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(got[10:], got[11:]))


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    np.testing.assert_allclose(float(A.global_norm(_torch(tree))),
                               float(JA.global_norm(tree)), rtol=1e-6)
    clipped, norm = A.clip_by_global_norm(_torch(tree), 1.0)
    assert abs(float(A.global_norm(clipped)) - 1.0) < 1e-6
    same, _ = A.clip_by_global_norm(_torch(tree), 1e6)      # no clip
    for a, b in zip(jax.tree_util.tree_leaves(same),
                    jax.tree_util.tree_leaves(_torch(tree))):
        assert torch.equal(a, b)


def test_grad_clip_reports_the_pre_clip_norm():
    opt = A.adam_init({"w": torch.zeros(3)})
    _, _, m = A.adam_update(A.AdamConfig(clip_norm=1.0),
                            {"w": torch.tensor([100.0, 0.0, 0.0])}, opt,
                            {"w": torch.zeros(3)})
    assert float(m["grad_norm"]) > 99


def test_adam_converges_quadratic():
    cfg = A.AdamConfig(lr=0.05, total_steps=200, warmup_steps=5,
                       weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = A.adam_init(params)
    for _ in range(200):
        params, opt, _ = A.adam_update(cfg, {"w": 2 * params["w"]}, opt,
                                       params)
    assert float((params["w"] ** 2).sum()) < 1e-2


def test_adam_update_records_no_graph():
    w = torch.ones(4, requires_grad=True)
    new, _, _ = A.adam_update(A.AdamConfig(), {"w": torch.ones(4)},
                              A.adam_init({"w": w}), {"w": w})
    assert new["w"].grad_fn is None and not new["w"].requires_grad


@pytest.mark.parametrize("difficulty", ["easy", "hard"])
def test_render_and_datasets_bitwise(difficulty):
    assert D.SEGMENTS == JD.SEGMENTS
    for d in range(10):
        got = D.render_digit(d, np.random.default_rng(d), 28, difficulty)
        want = JD.render_digit(d, np.random.default_rng(d), 28, difficulty)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for n, seed in ((512, 9), (300, 1)):
        x, y = D.make_dataset(n, seed=seed, difficulty=difficulty)
        jx, jy = JD.make_dataset(n, seed=seed, difficulty=difficulty)
        assert x.shape == (n, 28, 28, 1) and x.dtype == np.float32
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert x.min() >= 0.0 and x.max() <= 1.0


def test_digits_balanced_and_batches_bitwise():
    x, y = D.make_dataset(512, seed=9)
    assert np.bincount(y, minlength=10).min() > 20
    got = list(itertools.islice(D.batches(x, y, 96, seed=3), 12))
    want = list(itertools.islice(JD.batches(x, y, 96, seed=3), 12))
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == (96, 28, 28, 1)
        assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
