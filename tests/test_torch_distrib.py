"""The port's pipeline, ``compressed_psum`` and DTensor layouts over gloo
process groups against the reference's ``shard_map`` versions
(``repro.distrib.pipeline``, ``repro.optim.compression``).

The reference runs once, in a subprocess on 4 host devices (the device
count set before jax imports), and writes its inputs and results as
``.npz``. Four gloo ranks then run every distributed case of this file in
one spawn (``tests/torch_distrib_ranks.py``, no JAX), joined under a
timeout of its own, and write their results; the tests compare.

- The toy pipeline (L 8, D 16, B 12, 4 stages, 4 microbatches, ``tanh``,
  numpy inputs from a seed) within 1e-6 of the reference's and 1e-5 of the
  sequential stack.
- The granite smoke layers (f32, A8-W8, 2 stages on ranks 0 and 1, 2
  microbatches of 2 rows) within 1e-5 relative of the port's unpipelined
  stack and 1e-4 of the reference's ``forward`` hidden states, under
  ``params_from_jax``. The activation fake-quant is per tensor, so both
  sides run each microbatch as its own batch.
- ``compressed_psum`` given JAX's uniforms: bitwise the reference's at 2
  ranks; within 1e-6 of each leaf's max-abs at 4; the new residuals
  bitwise.
- The smoke params (fake-quant and W8) distributed under ``param_specs``
  on a 2 × 2 ``device_mesh``: local shapes = ``local_shape``,
  ``full_tensor()`` bitwise; ``constrain`` gives the placements its rule
  names.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_threads import _one_thread  # noqa: F401

import torch_distrib_ranks as R
from repro_torch.configs import get_smoke
from repro_torch.distrib.pipeline import stage_split
from repro_torch.models import transformer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
JOIN_S = 120

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.core.engine import AdaptiveEngine, QuantIndex
from repro.core.profiles import paper_profiles
from repro.distrib.pipeline import _CHECK_KW, _shard_map, pipeline_forward, stage_split
from repro.launch.sharding import _path_str
from repro.models import transformer as T
from repro.optim.compression import CompressionState, compressed_psum

d = sys.argv[1]
# the toy pipeline
z = np.load(os.path.join(d, "toy.npz"))
mesh = jax.make_mesh((4,), ("pod",))
def stage_fn(sp, xm):
    def body(h, w):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, xm, sp)[0]
staged = jax.device_put(stage_split(jnp.asarray(z["ws"]), 4),
                        NamedSharding(mesh, P("pod")))
y = pipeline_forward(stage_fn, staged, jnp.asarray(z["x"]), mesh=mesh,
                     n_microbatches=4)
np.savez(os.path.join(d, "toy_ref.npz"), y=np.asarray(y))

# granite smoke: params, the A8-W8 row, tokens, hidden per microbatch
cfg = get_smoke("granite-3-2b")
params = T.init_params(cfg, jax.random.PRNGKey(0))
names = T.quant_layer_names(cfg)
eng = AdaptiveEngine(tuple(paper_profiles(names)), QuantIndex(names),
                     lambda p, br, b: None)
bits = np.asarray(eng.table)[[p.name for p in eng.profiles].index("A8-W8")]
tokens = np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)).astype(np.int32)
hidden = np.concatenate([np.asarray(T.forward(params, cfg, jnp.asarray(bits),
                                              {"tokens": jnp.asarray(t)})[0])
                         for t in np.split(tokens, 2)])
flat = {"p:" + _path_str(p): np.asarray(l)
        for p, l in jax.tree_util.tree_flatten_with_path(params)[0]}
np.savez(os.path.join(d, "granite.npz"), bits=bits, tokens=tokens,
         hidden=hidden, **flat)

# compressed_psum under shard_map, per-rank keys; the uniforms it draws
c = dict(np.load(os.path.join(d, "compress_in.npz")))
def tree(kind, r):
    out = {}
    for k, v in c.items():
        if k.startswith(f"{kind}{r}:"):
            node = out
            *head, last = k.split(":", 1)[1].split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
    return out
res = dict(c)
for r in range(4):
    key = jax.random.PRNGKey(10 + r)
    leaves, tdef = jax.tree_util.tree_flatten_with_path(tree("g", r))
    keys = jax.random.split(key, len(leaves))
    for (p, l), k in zip(leaves, keys):
        res[f"u{r}:" + _path_str(p)] = np.asarray(
            jax.random.uniform(k, l.shape, jnp.float32))
for n in (2, 4):
    mesh = jax.make_mesh((n,), ("d",), devices=jax.devices()[:n])
    g = jax.tree.map(lambda *a: jnp.stack(a), *[tree("g", r) for r in range(n)])
    rr = jax.tree.map(lambda *a: jnp.stack(a), *[tree("r", r) for r in range(n)])
    keys = jnp.stack([jax.random.PRNGKey(10 + r) for r in range(n)])
    def body(g_, r_, k_):
        one = lambda t: jax.tree.map(lambda a: a[0], t)
        mean, st = compressed_psum(one(g_), CompressionState(one(r_)), k_[0],
                                   "d")
        return mean, jax.tree.map(lambda a: a[None], st.residual)
    mean, resid = _shard_map(body, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
                             out_specs=(P(), P("d")), **{_CHECK_KW: False})(
        g, rr, keys)
    for p, l in jax.tree_util.tree_flatten_with_path(mean)[0]:
        res[f"mean{n}:" + _path_str(p)] = np.asarray(l)
    for p, l in jax.tree_util.tree_flatten_with_path(resid)[0]:
        for r in range(n):
            res[f"res{n}_{r}:" + _path_str(p)] = np.asarray(l)[r]
np.savez(os.path.join(d, "compress.npz"), **res)
"""


def _toy_inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((8, 16, 16)) / np.sqrt(16)).astype(np.float32)
    x = rng.standard_normal((12, 16)).astype(np.float32)
    return ws, x


def _compress_inputs():
    """Per rank: a small gradient tree (an all-zero leaf among them) and a
    nonzero residual."""
    rng = np.random.default_rng(2)
    out = {}
    for r in range(WORLD):
        for path, shape in (("a", (3, 5)), ("b/c", (7,)), ("b/d", (2, 3)),
                            ("z", (4,))):
            g = rng.standard_normal(shape).astype(np.float32) * (r + 1)
            out[f"g{r}:{path}"] = g * 0 if path == "z" else g
            out[f"r{r}:{path}"] = (rng.standard_normal(shape) * 0.01
                                   ).astype(np.float32)
    return out


def _join(ctx, deadline: float) -> None:
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {JOIN_S} s")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference's subprocess, then one spawn of the four gloo ranks
    (``file://`` rendezvous under the test's own directory); returns the
    directory and each rank's results."""
    d = tmp_path_factory.mktemp("distrib")
    ws, x = _toy_inputs()
    np.savez(d / "toy.npz", ws=ws, x=x)
    np.savez(d / "compress_in.npz", **_compress_inputs())
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(d)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    ctx = mp.start_processes(R.run, args=(WORLD, str(d / "pg"), str(d)),
                             nprocs=WORLD, join=False, start_method="spawn")
    _join(ctx, time.monotonic() + JOIN_S)
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(WORLD)]


def test_stage_split_views_and_refusal():
    """Stage ``s`` holds layers ``[s·L/S, (s+1)·L/S)`` of every leaf as
    views; layers that do not split evenly are refused."""
    ws = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    stages = stage_split({"a": {"w": ws}, "b": ws[:, :1]}, 4)
    assert len(stages) == 4
    assert torch.equal(stages[2]["a"]["w"], ws[4:6])
    assert stages[3]["b"].data_ptr() == ws[6:, :1].data_ptr()
    with pytest.raises(ValueError, match="don't split into 3 stages"):
        stage_split({"w": ws}, 3)


def test_toy_pipeline_matches_reference_and_sequential(results):
    d, res = results
    ws, x = _toy_inputs()
    want = np.load(d / "toy_ref.npz")["y"]
    seq = torch.from_numpy(x)
    for w in torch.from_numpy(ws):
        seq = torch.tanh(seq @ w)
    for r in range(WORLD):                    # every rank returns y [B, D]
        y = res[r]["toy"]
        assert y.shape == (12, 16)
        assert np.abs(y.numpy() - want).max() <= 1e-6
        assert (y - seq).abs().max().item() <= 1e-5


def test_granite_pipeline_matches_stack_and_reference(results):
    d, res = results
    cfg = get_smoke("granite-3-2b")
    params, bits, tokens = R.granite_inputs(str(d))
    _, _, layer_bits = T.split_bits(cfg, bits)
    stack = []
    for t in tokens.split(2):
        x0, _, _ = T._embed_inputs(cfg, params, bits, {"tokens": t})
        h = T.layer_stack(cfg, params["layers"], layer_bits, x0)
        stack.append(T._norm(cfg, params["norm_f"], h))
    stack = torch.cat(stack)
    want = np.load(d / "granite.npz")["hidden"]
    for r in (0, 1):
        y = res[r]["granite"]
        assert y.shape == (4, 16, cfg.d_model)
        rel = ((y - stack).abs().max() / stack.abs().max()).item()
        assert rel <= 1e-5, rel
        assert np.abs(y.numpy() - want).max() <= 1e-4


def _tree_np(z, prefix):
    return {k.split(":", 1)[1]: z[k] for k in z.files
            if k.startswith(prefix + ":")}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        p = f"{pre}/{k}" if pre else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_reference(results, n):
    """Bitwise at 2 ranks; at 4 the sum's order may differ, so within 1e-6
    of each leaf's max-abs. Every rank's new residual is the reference's
    bit for bit (the local quantization error)."""
    d, res = results
    z = np.load(d / "compress.npz")
    want = _tree_np(z, f"mean{n}")
    assert set(want) == {"a", "b/c", "b/d", "z"}
    for r in range(n):
        mean, resid = res[r][f"psum{n}"]
        mean, resid = _flat(mean), _flat(resid)
        for path, w in want.items():
            got = mean[path].numpy()
            assert got.dtype == w.dtype == np.float32
            if n == 2:
                assert np.array_equal(got, w), path
            else:
                tol = 1e-6 * max(np.abs(w).max(), 1e-30)
                assert np.abs(got - w).max() <= tol, path
            assert np.array_equal(resid[path].numpy(),
                                  z[f"res{n}_{r}:{path}"]), path


def test_dtensor_round_trip_and_constraints(results):
    _, res = results
    for r in range(WORLD):
        rows = res[r]["dtensor"]
        assert len(rows) > 10 and any("/wq/0" in p for p, *_ in rows)
        for path, full, loc, want, same in rows:
            assert loc == want, path
            assert same, path
        # both mesh axes shard something: FSDP on data, TP on model
        assert any(loc[-1] * 2 == full[-1] and loc[-2] * 2 == full[-2]
                   for _, full, loc, _, _ in rows if len(full) == 3)
        c = res[r]["constrained"]
        assert c == [["S(0)", "S(2)"], ["R", "S(1)"], True, True]
