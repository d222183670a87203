"""The port's vision-language family (qwen2-vl) and the registry against
the JAX reference. The model runs on the qwen2-vl-2b smoke config (2
layers, d_model 64, 4 query heads over 2 KV heads of 16, M-RoPE sections
(2, 3, 3), a vision prefix of 8 patches, qkv bias, tied head) with the
reference's weights (``params_from_jax``); every input is drawn from a
numpy seed. The reference's forward, prefill and decode step are jitted
once per module.

Tolerances: hidden states within ``1e-5`` (absolute; f32 einsums contract
in another order than XLA's), logits within ``1e-4``, native leaves and
text M-RoPE against RoPE bitwise.

* ``apply_mrope`` on shifted streams at sections (2, 3, 3) and (16, 24,
  24); text M-RoPE = RoPE bit for bit, in the model too;
* ``forward`` and prefill + ``decode_step`` with ``patch_embeds`` at the
  float and A8-W8 profiles; the ragged vision prefix (a padded row's
  image columns zeroed, as the reference zeroes them);
* ``to_native`` at W8 and W4 bitwise (the qkv bias kept) and native
  logits;
* the refusals: the server and the launcher (tokens only), a batch shorter
  than the vision prefix;
* the registry: every architecture's full and smoke config field for
  field, the two ``ARCHS`` equal, and a smoke forward of the dense
  glm4-9b, qwen2-72b and qwen1.5-110b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke
from repro.core.profiles import Profile as JProfile
from repro.core.profiles import paper_profiles
from repro.core.profiles import profile_table as jax_profile_table
from repro.models import rotary as JR
from repro.models import transformer as JT
from repro.models.native import to_native as jax_to_native
import repro_torch.configs as C
from repro_torch.core import engine as TE
from repro_torch.core import profiles as TP
from repro_torch.launch import serve as S
from repro_torch.models import rotary as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import to_native
from repro_torch.serving.engine import AdaptiveServer, ServingConfig
from torch_threads import _one_thread  # noqa: F401

TOL = 1e-5
LOGIT_TOL = 1e-4
ARCH = "qwen2-vl-2b"
DENSE = ("glm4-9b", "qwen2-72b", "qwen1.5-110b")


def _parts(arch):
    cfg = get_smoke(arch)
    jp = jax.jit(JT.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, C.get_smoke(arch), jp, tp


@pytest.fixture(scope="module")
def parts():
    return _parts(ARCH)


@pytest.fixture(scope="module")
def jitted():
    """The reference's model entry points, jitted once per module."""
    return {"forward": jax.jit(JT.forward, static_argnums=1),
            "prefill": jax.jit(JT.prefill, static_argnums=(1, 4),
                               static_argnames=("kv_bits",)),
            "decode": jax.jit(JT.decode_step, static_argnums=1),
            "logits": jax.jit(JT._logits, static_argnums=0)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0,
                               err_msg=what)


def _row(cfg, profile):
    names = JT.quant_layer_names(cfg)
    if profile == "float":
        return np.asarray(jax_profile_table([JProfile.float32(names)],
                                            names)[0])
    profs = paper_profiles(names, inner_layers=[])
    return np.asarray(jax_profile_table(profs, names))[
        [p.name for p in profs].index(profile)]


def _batch(cfg, b, s, seed, plen=None):
    """Tokens ``[b, s]`` and ``patch_embeds [b, n_patches, d]`` (with
    ``prompt_len`` where given), as numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "patch_embeds": rng.standard_normal(
               (b, cfg.n_patches, cfg.d_model)).astype(np.float32)}
    if plen is not None:
        out["prompt_len"] = np.asarray(plen, np.int32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: (v if k == "prompt_len" else torch.from_numpy(v))
            for k, v in batch.items()}


def _tree(t, prefix=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree(v, prefix + (k,))
    else:
        yield prefix, t


# ---------------------------------------------------------------- config

def test_config_sites_and_param_tree_match_reference(parts):
    """qwen2-vl's sites are the dense four; ``init_params`` gives the
    reference's keys, shapes and dtypes (the qkv bias, the tied head)."""
    cfg, tcfg, jp, _ = parts
    assert T.sites(tcfg) == JT.sites(cfg) == ("qkv", "attn_out", "mlp_in",
                                              "mlp_out")
    assert T.quant_layer_names(tcfg) == JT.quant_layer_names(cfg)
    assert (tcfg.has_attn, tcfg.has_ssm, tcfg.has_mlp) == (True, False, True)
    mine_tree = T.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    mine = dict(_tree(mine_tree))
    want = dict(_tree(jax.tree.map(np.asarray, jp)))
    assert sorted(mine) == sorted(want)
    assert ("layers", "qkv", "b") in want and ("lm_head",) not in want
    for path, w in want.items():
        assert tuple(mine[path].shape) == w.shape, path
        assert str(mine[path].dtype) == f"torch.{w.dtype}", path
    assert T.param_count(mine_tree) == JT.param_count(jp)


# ---------------------------------------------------------------- M-RoPE

def _mrope_inputs(sections, seed):
    """x ``[2, 11, 3, D]`` and three position streams that differ: t runs,
    h steps every 4 tokens from 5, w cycles mod 4 from 11, each row
    shifted by a different offset (negative on row 1, a left pad)."""
    rng = np.random.default_rng(seed)
    d = 2 * sum(sections)
    x = rng.standard_normal((2, 11, 3, d)).astype(np.float32)
    ar = np.arange(11)
    streams = np.stack([ar, 5 + ar // 4, 11 + ar % 4])       # [3, S]
    pos = np.stack([streams + 3, streams - 2]).astype(np.int32)  # [2, 3, S]
    return x, pos


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_apply_mrope_matches_reference(sections):
    """Each frequency pair takes its angle from the stream ``sections``
    assigns it; the port's rotation equals the reference's within 1e-5,
    and a wrong section sum is refused."""
    x, pos = _mrope_inputs(sections, sum(sections))
    want = JR.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = R.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections,
                        1e6)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, TOL)
    # streams that differ move the result: not RoPE on any one stream
    for j in range(3):
        rope = R.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(pos[:, j]), 1e6)
        assert not torch.equal(rope, got)
    with pytest.raises(ValueError, match="sum"):
        R.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                      sections[:2], 1e6)


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_text_mrope_is_rope_bitwise(parts, sections):
    """With the three streams equal, M-RoPE is RoPE bit for bit (same f32
    angles, same rotation), on f32 and bf16 x; in the model, qwen2-vl's
    forward equals the same stack with ``mrope=False`` bit for bit."""
    x, pos = _mrope_inputs(sections, 7)
    p = torch.from_numpy(pos[:, 0])
    for dt in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dt)
        got = R.apply_mrope(xt, R.text_mrope_positions(p), sections, 1e4)
        assert got.dtype == dt
        assert torch.equal(got, R.apply_rope(xt, p, 1e4))
    if sections == (2, 3, 3):
        cfg, tcfg, _, tp = parts
        row = _row(cfg, "A8-W8")
        b = _tb(_batch(cfg, 2, 12, 3))
        h, _, _ = T.forward(tp, tcfg, row, b)
        h0, _, _ = T.forward(tp, dataclasses.replace(tcfg, mrope=False),
                             row, b)
        assert torch.equal(h, h0)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("profile", ["float", "A8-W8"])
def test_forward_matches_reference(parts, jitted, profile):
    """An image of 8 patches plus text: hidden states within 1e-5 and the
    logits of every position within 1e-4 of the reference's."""
    cfg, tcfg, jp, tp = parts
    row = _row(cfg, profile)
    batch = _batch(cfg, 3, 14, 11)
    jh, _, _ = jitted["forward"](jp, cfg, jnp.asarray(row), _jb(batch))
    th, _, _ = T.forward(tp, tcfg, row, _tb(batch))
    _close(th, jh, TOL)
    _close(T._logits(tcfg, tp, row, th),
           jitted["logits"](cfg, jp, jnp.asarray(row), jh), LOGIT_TOL)


@pytest.mark.parametrize("profile", ["float", "A8-W8"])
def test_prefill_decode_matches_reference(parts, jitted, profile):
    """Prefill of an image + text batch (12 columns) into a kv16 cache of
    24 slots, then 4 greedy decode steps (text, M-RoPE on text
    positions): every step's logits within 1e-4 and the same tokens."""
    cfg, tcfg, jp, tp = parts
    row = _row(cfg, profile)
    batch = _batch(cfg, 2, 12, 21)
    jl, jc = jitted["prefill"](jp, cfg, jnp.asarray(row), _jb(batch), 24)
    tl, tc = T.prefill(tp, tcfg, row, _tb(batch), 24)
    _close(tl, jl, LOGIT_TOL)
    pos = 12
    for _ in range(4):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(tok, tl.argmax(-1).numpy())
        p = np.full((2,), pos, np.int32)
        jl, jc = jitted["decode"](jp, cfg, jnp.asarray(row),
                                  jnp.asarray(tok[:, None]), jnp.asarray(p),
                                  jc)
        tl, tc = T.decode_step(tp, tcfg, row, torch.from_numpy(tok[:, None]),
                               torch.from_numpy(p), tc)
        _close(tl, jl, LOGIT_TOL, f"decode at {pos}")
        pos += 1


def test_ragged_vision_prefix_matches_reference(parts, jitted):
    """Rows of 14, 10 and 12 real columns left-padded to 14: the
    reference puts the image in the first 8 columns and then zeroes the
    pad columns, so a padded row loses its image's first patches. The
    port does the same (its outputs do not move when those patches
    change), and its prefill logits, hidden states and one decode step
    equal the reference's."""
    cfg, tcfg, jp, tp = parts
    row = _row(cfg, "A8-W8")
    batch = _batch(cfg, 3, 14, 31, plen=[14, 10, 12])
    jh, _, _ = jitted["forward"](jp, cfg, jnp.asarray(row), _jb(batch))
    th, _, _ = T.forward(tp, tcfg, row, _tb(batch))
    valid = np.arange(14)[None] >= (14 - batch["prompt_len"])[:, None]
    _close(_np(th)[valid], _np(jh)[valid], TOL)
    moved = dict(batch, patch_embeds=batch["patch_embeds"].copy())
    moved["patch_embeds"][1, :4] += 5.0          # row 1's pad columns
    moved["patch_embeds"][2, :2] -= 3.0          # row 2's pad columns
    th2, _, _ = T.forward(tp, tcfg, row, _tb(moved))
    assert torch.equal(th, th2)
    jl, jc = jitted["prefill"](jp, cfg, jnp.asarray(row), _jb(batch), 24)
    tl, tc = T.prefill(tp, tcfg, row, _tb(batch), 24)
    _close(tl, jl, LOGIT_TOL)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    p = batch["prompt_len"].copy()
    jl, _ = jitted["decode"](jp, cfg, jnp.asarray(row),
                             jnp.asarray(tok[:, None]), jnp.asarray(p), jc)
    tl, _ = T.decode_step(tp, tcfg, row, torch.from_numpy(tok[:, None]),
                          torch.from_numpy(p), tc)
    _close(tl, jl, LOGIT_TOL)


# ---------------------------------------------------------------- native

def _same_native_tree(got: dict, want: dict, w_bits: int) -> None:
    """Two native trees leaf for leaf, bitwise: a carrier's ints, scales,
    bits and width; every float leaf."""
    got, want = dict(_tree(got)), dict(_tree(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if hasattr(w, "_fields"):
            assert (g.bits, g.orig_last) == (w.bits, w.orig_last) and \
                g.bits == w_bits, path
            assert torch.equal(g.data, w.data), path
            assert torch.equal(g.scale, w.scale), path
        else:
            assert torch.equal(g, w), path


@pytest.mark.parametrize("w_bits", [8, 4])
def test_to_native_matches_reference(parts, jitted, w_bits):
    """``to_native`` bit for bit: every carrier's ints and scales, the
    qkv bias and the norms kept float, the tied table quantized; then the
    native forward's logits (the tied head dequantized) within 1e-4 of the
    reference's at A8-W8."""
    cfg, tcfg, jp, tp = parts
    jn = jax.jit(jax_to_native, static_argnums=1)(jp, w_bits)
    tn = params_from_jax(jax.tree.map(np.asarray, jn), device="cpu")
    _same_native_tree(to_native(tp, w_bits), tn, w_bits)
    assert ("layers", "qkv", "b") in dict(_tree(tn))
    row = _row(cfg, "A8-W8")
    batch = _batch(cfg, 2, 12, 41)
    jh, _, _ = jitted["forward"](jn, cfg, jnp.asarray(row), _jb(batch))
    th, _, _ = T.forward(tn, tcfg, row, _tb(batch))
    _close(T._logits(tcfg, tn, row, th[:, -1:]),
           jitted["logits"](cfg, jn, jnp.asarray(row), jh[:, -1:]),
           LOGIT_TOL)


# ---------------------------------------------------------------- refusals

def test_refusals(parts, capsys):
    """The server takes token prompts only: it and the launcher refuse the
    vision stack by name (the reference's prefill fails on tokens alone
    with ``KeyError: 'patch_embeds'``); a batch shorter than the vision
    prefix raises ``ValueError`` naming both lengths."""
    cfg, tcfg, jp, tp = parts
    names = T.quant_layer_names(tcfg)
    teng = TE.AdaptiveEngine(tuple(TP.paper_profiles(names)),
                             TE.QuantIndex(names))
    with pytest.raises(ValueError, match="patch_embeds"):
        AdaptiveServer(tcfg, tp, teng, ServingConfig(slots=64),
                       device="cpu")
    with pytest.raises(SystemExit, match="token prompts only"):
        S.main(["--arch", ARCH, "--device", "cpu"])
    row = _row(cfg, "float")
    toks = np.zeros((1, 10), np.int32)
    with pytest.raises(KeyError, match="patch_embeds"):
        JT.prefill(jp, cfg, jnp.asarray(row), {"tokens": jnp.asarray(toks)},
                   16)
    short = _batch(cfg, 1, 6, 0)
    with pytest.raises(ValueError, match="6 columns.*8 patches"):
        T.forward(tp, tcfg, row, _tb(short))


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("arch", JARCHS)
def test_registry_matches_reference(jitted, arch):
    """The port's registry is the reference's, in its order; every full and
    smoke config equals the reference's field for field (the MoE and SSM
    sub-configs as dicts). The dense glm4-9b, qwen2-72b and qwen1.5-110b,
    which need no code of their own, pass a smoke forward at A8-W8:
    hidden states within 1e-5, last logits within 1e-4."""
    assert C.ARCHS == JARCHS
    for mine, ref in ((C.get_config(arch), jax_get_config(arch)),
                      (C.get_smoke(arch), get_smoke(arch))):
        assert type(mine).__name__ == type(ref).__name__ == "ModelConfig"
        for f in dataclasses.fields(ref):
            a, b = getattr(mine, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(b):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
            else:
                assert a == b, f.name
        assert set(f.name for f in dataclasses.fields(mine)) == \
            set(f.name for f in dataclasses.fields(ref))
        assert T.quant_layer_names(mine) == JT.quant_layer_names(ref)
    if arch not in DENSE:
        return
    cfg, tcfg, jp, tp = _parts(arch)
    assert tcfg.family == "dense"
    row = _row(cfg, "A8-W8")
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jh, _, _ = jitted["forward"](jp, cfg, jnp.asarray(row),
                                 {"tokens": jnp.asarray(toks)})
    th, _, _ = T.forward(tp, tcfg, row, {"tokens": torch.from_numpy(toks)})
    _close(th, jh, TOL)
    _close(T._logits(tcfg, tp, row, th[:, -1:]),
           jitted["logits"](cfg, jp, jnp.asarray(row), jh[:, -1:]), LOGIT_TOL)
