"""The port's audio family (hubert) and its layer norm against the JAX
reference. The model runs on the hubert-xlarge smoke config (2 layers,
d_model 64, 4 query heads over 2 KV heads of 16, layer norms with a
shift, bidirectional attention, a non-gated GELU MLP, 32-dim frame
features, 512 units) with the reference's weights (``params_from_jax``);
every input is drawn from a numpy seed. The reference's entry points are
jitted once per module.

Tolerances: hidden states within ``1e-5`` (absolute; f32 reductions run in
another order than XLA's), logits within ``1e-4``, native leaves bitwise.

* ``layer_norm`` (two-pass, f32) with and without its shift;
* the parameter tree (the ``embed`` linear, the norms' shifts, the untied
  head), hidden states and per-frame logits at the float and A8-W8
  profiles, plain and on a left-padded ragged batch (real frames = each
  clip's solo forward);
* ``to_native`` at W8 and W4 bitwise (the embed linear and the untied
  head) and native frame logits;
* ``prequant_decode_weights`` building no image of the audio embed, as the
  reference's;
* the decode side refused on the encoder (server, launcher, ``prefill``,
  ``init_caches``, ``init_paged_caches``, ``decode_step``);
* the norm dispatch: with ``norm="ln"`` on a dense stack (``forward``,
  prefill + ``decode_step``, ``forward_extend``, ``decode_step_spec``), an
  SSM stack (``forward`` + ``decode_step``) and an MoE stack
  (``forward``), with random gains and shifts, against the reference at
  every norm site.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core.profiles import paper_profiles
from repro.core.profiles import profile_table as jax_profile_table
from repro.launch import serve as JL
from repro.models import layers as JLY
from repro.models import transformer as JT
from repro.models.native import to_native as jax_to_native
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.launch import serve as S
from repro_torch.models import layers as LY
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import to_native
from repro_torch.serving.engine import AdaptiveServer, ServingConfig
from test_torch_vlm import _close, _np, _row, _same_native_tree, _tree
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "hubert-xlarge"


@pytest.fixture(scope="module")
def parts():
    cfg = get_smoke(ARCH)
    jp = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, C.get_smoke(ARCH), jp, tp


@pytest.fixture(scope="module")
def jitted():
    """The reference's model entry points, jitted once per module."""
    return {"forward": jax.jit(JT.forward, static_argnums=1),
            "prefill": jax.jit(JT.prefill, static_argnums=(1, 4),
                               static_argnames=("kv_bits",)),
            "decode": jax.jit(JT.decode_step, static_argnums=1),
            "spec": jax.jit(JT.decode_step_spec, static_argnums=1),
            "extend": jax.jit(JT.forward_extend, static_argnums=1),
            "logits": jax.jit(JT._logits, static_argnums=0)}


def _features(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.feature_dim)).astype(np.float32)


# ---------------------------------------------------------------- layer norm

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_matches_reference(dtype, bias):
    """Inputs with a mean of 3 and a spread of 2 (the two-pass variance
    matters), random gains and shifts: f32 within 1e-5, bf16 within one
    bf16 step; without ``b`` the shift is zero on both sides."""
    rng = np.random.default_rng(5 + bias)
    x = (3 + 2 * rng.standard_normal((3, 7, 64))).astype(np.float32)
    p = {"g": (1 + 0.3 * rng.standard_normal(64)).astype(np.float32)}
    if bias:
        p["b"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = JLY.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x).astype(jd))
    got = LY.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x).to(td))
    assert got.dtype == td
    if dtype == "f32":
        _close(got, want, TOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7,
                                   atol=1e-6)


# ---------------------------------------------------------------- model

def test_config_sites_and_param_tree_match_reference(parts):
    """hubert's sites are the dense four; ``init_params`` gives the
    reference's keys, shapes and dtypes: the ``embed`` linear ``[32,
    64]``, every norm with a shift, the non-gated MLP, the untied head."""
    cfg, tcfg, jp, _ = parts
    assert T.sites(tcfg) == JT.sites(cfg) == ("qkv", "attn_out", "mlp_in",
                                              "mlp_out")
    assert T.quant_layer_names(tcfg) == JT.quant_layer_names(cfg)
    mine_tree = T.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    mine = dict(_tree(mine_tree))
    want = dict(_tree(jax.tree.map(np.asarray, jp)))
    assert sorted(mine) == sorted(want)
    for key in (("embed", "w"), ("norm_f", "b"), ("layers", "norm_attn", "b"),
                ("layers", "norm_mlp", "b"), ("lm_head", "w")):
        assert key in want, key
    assert want[("embed", "w")].shape == (32, 64)
    assert want[("layers", "mlp", "w_in", "w")].shape == (2, 64, 128)
    for path, w in want.items():
        assert tuple(mine[path].shape) == w.shape, path
        assert str(mine[path].dtype) == f"torch.{w.dtype}", path
    for path in (("norm_f", "b"), ("layers", "norm_mlp", "b")):
        assert not mine[path].any()
    assert T.param_count(mine_tree) == JT.param_count(jp)


@pytest.mark.parametrize("profile", ["float", "A8-W8"])
def test_forward_matches_reference(parts, jitted, profile):
    """20 frames of 3 clips: hidden states within 1e-5, every frame's unit
    logits within 1e-4."""
    cfg, tcfg, jp, tp = parts
    row = _row(cfg, profile)
    feats = _features(cfg, 3, 20, 11)
    jh, _, _ = jitted["forward"](jp, cfg, jnp.asarray(row),
                                 {"features": jnp.asarray(feats)})
    th, _, _ = T.forward(tp, tcfg, row, {"features": torch.from_numpy(feats)})
    _close(th, jh, TOL)
    tl = T._logits(tcfg, tp, row, th)
    assert tl.shape == (3, 20, cfg.vocab)
    _close(tl, jitted["logits"](cfg, jp, jnp.asarray(row), jh), LOGIT_TOL)


@pytest.mark.parametrize("profile", ["float", "A8-W8"])
def test_ragged_forward_matches_reference_and_solo(parts, jitted, profile):
    """Clips of 20, 13 and 6 frames left-padded to 20 (``prompt_len``):
    on the real frames, hidden states and logits equal the reference's
    ragged forward and each clip's solo forward (pad keys masked out of
    the bidirectional attention, pad frames zeroed)."""
    cfg, tcfg, jp, tp = parts
    row = _row(cfg, profile)
    lens = np.array([20, 13, 6], np.int32)
    feats = _features(cfg, 3, 20, 12)
    jh, _, _ = jitted["forward"](jp, cfg, jnp.asarray(row), {
        "features": jnp.asarray(feats), "prompt_len": jnp.asarray(lens)})
    th, _, _ = T.forward(tp, tcfg, row, {"features": torch.from_numpy(feats),
                                         "prompt_len": lens})
    tl = T._logits(tcfg, tp, row, th)
    jl = jitted["logits"](cfg, jp, jnp.asarray(row), jh)
    for j, n in enumerate(lens):
        _close(th[j, 20 - n:], np.asarray(jh)[j, 20 - n:], TOL, f"clip {j}")
        _close(tl[j, 20 - n:], np.asarray(jl)[j, 20 - n:], LOGIT_TOL)
        solo, _, _ = T.forward(tp, tcfg, row, {
            "features": torch.from_numpy(feats[j:j + 1, 20 - n:])})
        _close(th[j, 20 - n:], solo[0], TOL, f"clip {j} solo")


@pytest.mark.parametrize("w_bits", [8, 4])
def test_to_native_matches_reference(parts, jitted, w_bits):
    """``to_native`` bit for bit (the ``embed`` linear ``[32, 64]`` and the
    untied head converted, the norms' shifts kept float); native frame
    logits within 1e-4 of the reference's at A8-W8."""
    cfg, tcfg, jp, tp = parts
    jn = jax.jit(jax_to_native, static_argnums=1)(jp, w_bits)
    tn = params_from_jax(jax.tree.map(np.asarray, jn), device="cpu")
    got = to_native(tp, w_bits)
    _same_native_tree(got, tn, w_bits)
    assert got["embed"]["wq"].orig_last == cfg.d_model
    assert got["lm_head"]["wq"].orig_last == cfg.vocab
    row = _row(cfg, "A8-W8")
    feats = _features(cfg, 2, 16, 13)
    jh, _, _ = jitted["forward"](jn, cfg, jnp.asarray(row),
                                 {"features": jnp.asarray(feats)})
    th, _, _ = T.forward(tn, tcfg, row, {"features": torch.from_numpy(feats)})
    _close(th, jh, TOL)
    _close(T._logits(tcfg, tn, row, th),
           jitted["logits"](cfg, jn, jnp.asarray(row), jh), LOGIT_TOL)


def test_prequant_builds_no_image_of_the_audio_embed(parts):
    """The audio ``embed`` is a linear over frame features, not a table:
    like the reference's ``prequant_decode_weights``, the port's overlays
    hold images of the head and the layers' linears but none of it, and
    each image equals the reference's."""
    cfg, tcfg, jp, tp = parts
    names = JT.quant_layer_names(cfg)
    profs = paper_profiles(names, inner_layers=[])
    table = np.asarray(jax_profile_table(profs, names))
    want = jax.jit(JT.prequant_decode_weights, static_argnums=1)(
        jp, cfg, jnp.asarray(table))
    got = T.prequant_decode_weights(tp, tcfg, table)
    assert "embed" not in want and "lm_head" in want
    for pid, ov in enumerate(got):
        assert "embed" not in ov
        ov_paths = dict(_tree(ov))
        want_paths = dict(_tree(jax.tree.map(lambda a: np.asarray(a)[pid],
                                             want)))
        assert sorted(ov_paths) == sorted(want_paths)
        for path, w in want_paths.items():
            assert np.array_equal(_np(ov_paths[path]), w), (pid, path)


def test_decode_side_refuses_the_encoder(parts, monkeypatch):
    """An encoder has no decode step: ``prefill``, ``init_caches``,
    ``init_paged_caches`` and ``decode_step`` raise ``ValueError`` (the
    reference would look its frames up in a linear); the server refuses
    the stack, and the launcher exits with the reference launcher's
    message."""
    cfg, tcfg, jp, tp = parts
    row = _row(cfg, "float")
    with pytest.raises(ValueError, match="encoder-only"):
        T.prefill(tp, tcfg, row, {"features": torch.zeros(1, 4, 32)}, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        T.init_caches(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        T.init_paged_caches(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step(tp, tcfg, row, torch.zeros((1, 1), dtype=torch.int32),
                      torch.zeros((1,), dtype=torch.int32), {})
    names = T.quant_layer_names(tcfg)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names)),
                             TE.QuantIndex(names))
    with pytest.raises(ValueError, match="encoder-only"):
        AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64),
                       device="cpu")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH])
    with pytest.raises(SystemExit) as ref:
        JL.main()
    with pytest.raises(SystemExit) as mine:
        S.main(["--arch", ARCH, "--device", "cpu"])
    assert str(mine.value) == str(ref.value) == \
        "encoder-only arch has no decode step"


# ---------------------------------------------------------------- norm sites

@functools.lru_cache(maxsize=None)
def _ln_parts(arch, seed):
    """``arch``'s smoke config with ``norm="ln"`` on both sides and the
    reference's weights, every norm's gain and shift drawn at random (so
    a site that skips its shift, or takes the RMS norm, moves the
    output)."""
    cfg = dataclasses.replace(get_smoke(arch), norm="ln")
    tcfg = dataclasses.replace(C.get_smoke(arch), norm="ln")
    jp = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    n = 0

    def perturb(tree, name=""):
        nonlocal n
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, k)
            elif name.startswith("norm") and k in ("g", "b"):
                base = 1.0 if k == "g" else 0.0
                tree[k] = (base + 0.3 * rng.standard_normal(v.shape)).astype(
                    np.float32)
                n += 1

    perturb(jp)
    assert n
    return cfg, tcfg, jax.tree.map(jnp.asarray, jp), params_from_jax(
        jp, device="cpu")


@pytest.mark.parametrize("path", ["forward", "decode", "extend", "spec",
                                  "ssm", "moe"])
def test_norm_dispatch_at_every_site(jitted, path):
    """``_norm`` takes the layer norm at every site the reference's does:
    ``norm_attn`` and ``norm_mlp`` in ``forward``, ``decode_step``,
    ``forward_extend`` and ``decode_step_spec``, ``norm_ssm`` in the SSM
    forward and decode step, the MoE layer's ``norm_mlp``, and ``norm_f``
    everywhere — outputs within 1e-5 (hidden) and 1e-4 (logits)."""
    arch = {"ssm": "mamba2-130m", "moe": "qwen2-moe-a2.7b"}.get(
        path, "granite-3-2b")
    cfg, tcfg, jp, tp = _ln_parts(arch, 7)
    if path == "moe":       # capacity large enough that nothing drops
        cfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0)) for c in (cfg, tcfg))
    row = _row(cfg, "A8-W8")
    jrow = jnp.asarray(row)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if path in ("forward", "ssm", "moe"):
        jh, _, _ = jitted["forward"](jp, cfg, jrow, jb)
        th, _, _ = T.forward(tp, tcfg, row, tb)
        _close(th, jh, TOL)
        if path != "ssm":
            return
    if path in ("decode", "ssm", "spec"):
        jl, jc = jitted["prefill"](jp, cfg, jrow, jb, 16)
        tl, tc = T.prefill(tp, tcfg, row, tb, 16)
        _close(tl, jl, LOGIT_TOL)
        nxt = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
        pos = np.full((2,), 10, np.int32)
        if path == "spec":
            jl, _, _ = jitted["spec"](jp, cfg, jrow, jnp.asarray(nxt),
                                      jnp.asarray(pos), jc)
            tl, _, _ = T.decode_step_spec(tp, tcfg, row,
                                          torch.from_numpy(nxt),
                                          torch.from_numpy(pos), tc)
            _close(tl, jl, LOGIT_TOL)
            return
        for i in range(3):
            jl, jc = jitted["decode"](jp, cfg, jrow, jnp.asarray(nxt[:, i:i + 1]),
                                      jnp.asarray(pos + i), jc)
            tl, tc = T.decode_step(tp, tcfg, row,
                                   torch.from_numpy(nxt[:, i:i + 1]),
                                   torch.from_numpy(pos + i), tc)
            _close(tl, jl, LOGIT_TOL, f"decode step {i}")
        return
    # extend: a suffix of 10 tokens after random prefixes of 6 and 3
    hkv, hd = cfg.n_kv, cfg.hd
    plen = np.array([6, 3], np.int32)
    pk = rng.standard_normal((cfg.n_layers, 2, 8, hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((cfg.n_layers, 2, 8, hkv, hd)).astype(np.float32)
    for j, n in enumerate(plen):
        pk[:, j, n:] = pv[:, j, n:] = 0
    slen = np.array([10, 7], np.int32)
    jh, _ = jitted["extend"](jp, cfg, jrow, dict(
        jb, prompt_len=jnp.asarray(slen)), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(plen))
    th, _ = T.forward_extend(tp, tcfg, row, dict(tb, prompt_len=slen),
                             torch.from_numpy(pk), torch.from_numpy(pv),
                             torch.from_numpy(plen))
    for j, n in enumerate(slen):
        _close(th[j, 10 - n:], np.asarray(jh)[j, 10 - n:], TOL)
