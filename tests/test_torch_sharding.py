"""The port's sharding rules, mesh descriptions and activation constraints
against the reference's (``repro.launch.sharding``, ``repro.launch.mesh``,
``repro.models.pshard``).

The reference runs once, in a subprocess with its own host-device count
set before jax imports; it writes every spec it computes (parameters of
every arch at full and smoke size, fake-quant / W8 / W4, serve on and off,
on the pod1, pod2, tiny and tiny2 meshes; caches at kv16/8/4; batches of
every ``SHAPES`` entry; ``shape_applicable``; per-device parameter bytes
from ``NamedSharding.shard_shape`` on the production meshes; ``pshard``'s
decisions captured by patching ``NamedSharding`` and
``with_sharding_constraint``) into one JSON file. The port computes the
same over its ``meta`` trees."""
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import _one_thread  # noqa: F401

from repro_torch.configs import (ARCHS, SHAPES, get_config, get_smoke,
                                 shape_applicable)
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (Mesh, dp_axes, dp_size,
                                     make_production_mesh, make_tiny_mesh)
from repro_torch.models import pshard
from repro_torch.models.attention import KVCache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    """Duck-typed mesh exposing .shape / .axis_names for the rule table."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16},
          "tiny": {"data": 2, "model": 2},
          "tiny2": {"pod": 2, "data": 2, "model": 2}}
FORMS = {"fake": None, "w8": 8, "w4": 4}
PSHARD_CASES = [
    ((8, 2, 4, 64, 16), ("dp", None, None, "tp", None)),
    ((8, 2, 64, 16), ("dp", None, None, None)),
    ((1, 2, 4, 100, 16), ("dp", None, None, "tp", None)),
    ((4, 8, 2, 4, 32, 16), (None, "dp", None, None, "tp", None)),
    ((32, 128, 8192), ("dp", None, "tp")),
    ((32, 128, 50), ("dp", None, "tp")),
    ((16, 60, 48, 2048), ("dp", "tp", None, None)),
    ((16, 64, 48, 2048), ("dp", "tp", None, None)),
    ((8, 256, 50, 64), ("dp", None, None, "tp")),
    ((8, 50, 4, 256, 256), ("dp", None, None, "tp", None)),
    ((8, 4, 256, 50, 64), ("dp", None, "tp", None, None)),
    ((256, 4096, 2048), ("dp", None, None)),
    ((1, 1, 2048), ("dp", None, None)),
    ((256, 1024, 152064), ("dp", None, "tp")),
    ((3, 5), (None, None)),
]

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS, SHAPES, get_config, get_smoke, shape_applicable
from repro.launch import specs as S, sharding as shd
from repro.launch.mesh import make_production_mesh
from repro.launch.sharding import _path_str
from repro.models import pshard

MESHES = json.loads(sys.argv[2])
FORMS = {"fake": None, "w8": 8, "w4": 4}
PSHARD_CASES = json.loads(sys.argv[3])

class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

def flat(tree, specs):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(sp)
    return [[_path_str(p), list(l.shape), str(l.dtype), enc(s)]
            for (p, l), s in zip(leaves, sp)]

out = {"params": {}, "caches": {}, "batch": {}, "applicable": {},
       "bytes": {}, "pshard": {}}
for arch in ARCHS:
    for size, get in (("full", get_config), ("smoke", get_smoke)):
        cfg = get(arch)
        for s in SHAPES.values():
            out["applicable"][f"{arch}|{size}|{s.name}"] = list(
                shape_applicable(cfg, s))
        for form, nb in FORMS.items():
            try:
                p = S.abstract_params(cfg, native_bits=nb)
            except Exception as e:
                out["params"][f"{arch}|{size}|{form}"] = {
                    "refused": f"{type(e).__name__}"}
                continue
            for mname, mshape in MESHES.items():
                mesh = FakeMesh(mshape)
                for serve in (False, True):
                    out["params"][f"{arch}|{size}|{form}|{serve}|{mname}"] = \
                        flat(p, shd.param_specs(p, mesh, serve=serve))
        if cfg.causal:
            for kv in (16, 8, 4):
                c = S.abstract_caches(cfg, SHAPES["decode_32k"], kv_bits=kv)
                for mname, mshape in MESHES.items():
                    out["caches"][f"{arch}|{size}|{kv}|{mname}"] = flat(
                        c, shd.cache_specs(c, FakeMesh(mshape)))
    cfg = get_config(arch)
    for s in SHAPES.values():
        b = S.input_specs(cfg, s)
        for mname, mshape in MESHES.items():
            out["batch"][f"{arch}|{s.name}|{mname}"] = flat(
                b, shd.batch_specs(b, FakeMesh(mshape)))

for arch in ("qwen2-72b", "qwen1.5-110b"):
    p = S.abstract_params(get_config(arch))
    for mname, multi in (("pod1", False), ("pod2", True)):
        mesh = make_production_mesh(multi_pod=multi)
        specs = shd.param_specs(p, mesh)
        tot = 0
        for l, s in zip(jax.tree_util.tree_leaves(p),
                        jax.tree_util.tree_leaves(
                            specs, is_leaf=lambda x: isinstance(x, P))):
            shard = NamedSharding(mesh, s).shard_shape(l.shape)
            tot += int(np.prod(shard)) * np.dtype(l.dtype).itemsize
        out["bytes"][f"{arch}|{mname}"] = tot

seen = []
pshard.NamedSharding = lambda mesh, spec: spec
jax.lax.with_sharding_constraint = lambda x, spec: (seen.append(spec), x)[1]
for mname, mshape in MESHES.items():
    dp = tuple(a for a in ("pod", "data") if a in mshape)
    pshard.enable(FakeMesh(mshape), dp[0] if len(dp) == 1 else dp)
    for i, (shape, logical) in enumerate(PSHARD_CASES):
        seen.clear()
        pshard.constrain(jax.ShapeDtypeStruct(tuple(shape), jnp.float32),
                         *logical)
        out["pshard"][f"{mname}|{i}"] = enc(seen[0]) if seen else None
    pshard.disable()
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the reference's subprocess at once; ``reference()`` waits for
    it and returns its JSON."""
    path = tmp_path_factory.mktemp("ref") / "sharding.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(path), json.dumps(MESHES),
         json.dumps(PSHARD_CASES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    box = {}

    def get():
        if "data" not in box:
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, out
            box["data"] = json.loads(path.read_text())
        return box["data"]
    yield get
    if proc.poll() is None:
        proc.kill()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, specs):
    leaves = shd.flatten_with_path(tree)
    sp = shd.flatten_with_path(specs)
    assert [p for p, _ in leaves] == [p for p, _ in sp]
    return [[p, list(l.shape), str(l.dtype).replace("torch.", ""), _enc(s)]
            for (p, l), (_, s) in zip(leaves, sp)]


# ---------------------------------------------------------------------------
# the reference's rule tests (tests/test_sharding_rules.py) on the port
# ---------------------------------------------------------------------------

def test_embed_and_head_specs():
    tree = {"embed": {"w": _meta(152064, 8192)},
            "lm_head": {"w": _meta(8192, 152064)}}
    specs = shd.param_specs(tree, MESH1)
    assert specs["embed"]["w"] == ("model", "data")
    assert specs["lm_head"]["w"] == ("data", "model")


def test_column_row_pairs():
    tree = {"layers": {"qkv": {"w": _meta(80, 8192, 10240)},
                       "attn_out": {"w": _meta(80, 8192, 8192)},
                       "mlp": {"w_in": {"w": _meta(80, 8192, 59136)},
                               "w_out": {"w": _meta(80, 29568, 8192)}}}}
    specs = shd.param_specs(tree, MESH1)
    assert specs["layers"]["qkv"]["w"] == (None, "data", "model")
    assert specs["layers"]["attn_out"]["w"] == (None, "model", "data")
    assert specs["layers"]["mlp"]["w_in"]["w"] == (None, "data", "model")
    assert specs["layers"]["mlp"]["w_out"]["w"] == (None, "model", "data")


def test_multipod_fsdp_uses_pod_and_data():
    tree = {"layers": {"qkv": {"w": _meta(80, 8192, 10240)}}}
    specs = shd.param_specs(tree, MESH2)
    assert specs["layers"]["qkv"]["w"] == (None, ("pod", "data"), "model")


def test_moe_expert_parallel():
    tree = {"layers": {"moe": {"w_in": _meta(28, 64, 2048, 2816),
                               "w_out": _meta(28, 64, 1408, 2048),
                               "router": {"w": _meta(28, 2048, 64)}}}}
    specs = shd.param_specs(tree, MESH1)
    assert specs["layers"]["moe"]["w_in"] == (None, "model", "data")
    assert specs["layers"]["moe"]["w_out"][1] == "model"
    assert specs["layers"]["moe"]["router"]["w"] == (None, "data")


def test_norms_replicated():
    specs = shd.param_specs({"layers": {"norm_attn": {"g": _meta(80, 8192)}}},
                            MESH1)
    assert specs["layers"]["norm_attn"]["g"] == ()


def test_divisibility_fallback():
    """Dims that don't divide the axis are silently replicated, not errors."""
    tree = {"layers": {"qkv": {"w": _meta(2, 100, 999)}}}  # 999 % 16 != 0
    specs = shd.param_specs(tree, MESH1)
    assert specs["layers"]["qkv"]["w"] == ()  # both dims dropped (100 too)


def test_batch_specs_and_long500k_fallback():
    b = {"tokens": _meta(256, 4096), "labels": _meta(256, 4096)}
    specs = shd.batch_specs(b, MESH1)
    assert specs["tokens"] == ("data",)
    one = shd.batch_specs({"tokens": _meta(1, 524288)}, MESH1)
    assert one["tokens"] == ()  # batch=1 can't shard → replicate, don't fail


def test_cache_specs():
    i32 = torch.int32
    kv = KVCache(k=_meta(80, 128, 32768, 8, 128), v=_meta(80, 128, 32768, 8, 128),
                 k_scale=_meta(80, 128, 8), v_scale=_meta(80, 128, 8),
                 token_idx=_meta(80, 128, 32768, dtype=i32))
    specs = shd.cache_specs({"kv": kv}, MESH1)
    assert specs["kv"].k[1] == "data"          # batch over data
    assert specs["kv"].k[2] == "model"         # Hkv=8 % 16 → slots sharded
    assert specs["kv"].token_idx == (None, "data", "model")
    # divisible Hkv → heads sharded instead
    kv16 = KVCache(k=_meta(28, 128, 32768, 16, 128),
                   v=_meta(28, 128, 32768, 16, 128),
                   k_scale=_meta(28, 128, 16), v_scale=_meta(28, 128, 16),
                   token_idx=_meta(28, 128, 32768, dtype=i32))
    specs16 = shd.cache_specs({"kv": kv16}, MESH1)
    assert specs16["kv"].k[3] == "model"


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

def test_mesh_descriptions():
    """The reference's meshes' shapes and dp axes, with no device state;
    ``device_mesh`` refuses without a process group."""
    pod1, pod2 = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert dict(pod1.shape) == MESHES["pod1"] and pod1.size == 256
    assert dict(pod2.shape) == MESHES["pod2"] and pod2.size == 512
    assert pod2.axis_names == ("pod", "data", "model")
    assert dict(make_tiny_mesh(2, 2).shape) == MESHES["tiny"]
    assert dict(make_tiny_mesh(2, 2, multi_pod=True).shape) == MESHES["tiny2"]
    assert dp_axes(pod2) == ("pod", "data") and dp_size(pod2) == 32
    assert dp_axes(pod1) == ("data",) and dp_size(pod1) == 16
    assert Mesh({"data": 2}) == Mesh({"data": 2})
    from repro_torch.launch.mesh import device_mesh
    with pytest.raises(RuntimeError, match="no process group"):
        device_mesh(pod1, "cpu")


# ---------------------------------------------------------------------------
# parity with the reference, leaf by leaf and path by path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(reference, arch, size):
    """Every leaf's path, shape, dtype and spec, for fake-quant, W8 and W4
    parameters, serve off and on, on all four meshes; a conversion the
    reference refuses (hymba's odd-vocab head at W4) the port refuses
    too."""
    ref = reference()["params"]
    cfg = (get_config if size == "full" else get_smoke)(arch)
    for form, nb in FORMS.items():
        key = f"{arch}|{size}|{form}"
        if key in ref:
            assert "refused" in ref[key]
            with pytest.raises(ValueError):
                S.abstract_params(cfg, native_bits=nb)
            continue
        p = S.abstract_params(cfg, native_bits=nb)
        for mname, mshape in MESHES.items():
            for serve in (False, True):
                got = _flat(p, shd.param_specs(p, FakeMesh(mshape),
                                               serve=serve))
                assert got == ref[f"{key}|{serve}|{mname}"], (form, mname,
                                                              serve)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(reference, arch):
    """Cache specs at kv16/8/4 (decode_32k's slots, full and smoke), batch
    specs of every ``SHAPES`` entry, on all four meshes."""
    ref = reference()
    for size, get in (("full", get_config), ("smoke", get_smoke)):
        cfg = get(arch)
        if not cfg.causal:
            assert not any(k.startswith(f"{arch}|{size}|")
                           for k in ref["caches"])
            continue
        for kv in (16, 8, 4):
            c = S.abstract_caches(cfg, SHAPES["decode_32k"], kv_bits=kv)
            for mname, mshape in MESHES.items():
                got = _flat(c, shd.cache_specs(c, FakeMesh(mshape)))
                assert got == ref["caches"][f"{arch}|{size}|{kv}|{mname}"]
    cfg = get_config(arch)
    for s in SHAPES.values():
        b = S.input_specs(cfg, s)
        for mname, mshape in MESHES.items():
            got = _flat(b, shd.batch_specs(b, FakeMesh(mshape)))
            assert got == ref["batch"][f"{arch}|{s.name}|{mname}"]


def test_shape_applicable_matches_reference(reference):
    ref = reference()["applicable"]
    for arch in ARCHS:
        for size, get in (("full", get_config), ("smoke", get_smoke)):
            for s in SHAPES.values():
                assert list(shape_applicable(get(arch), s)) == \
                    ref[f"{arch}|{size}|{s.name}"]


@pytest.mark.parametrize("arch", ["qwen2-72b", "qwen1.5-110b"])
def test_per_device_param_bytes_match_reference(reference, arch):
    """The sum of each leaf's shard under ``local_bytes`` equals the sum
    of the reference's ``NamedSharding.shard_shape`` bytes on the 256- and
    512-device production meshes."""
    ref = reference()["bytes"]
    p = S.abstract_params(get_config(arch))
    for mname, multi in (("pod1", False), ("pod2", True)):
        mesh = make_production_mesh(multi_pod=multi)
        specs = dict(shd.flatten_with_path(shd.param_specs(p, mesh)))
        got = sum(shd.local_bytes(t, specs[path], mesh)
                  for path, t in shd.flatten_with_path(p))
        assert got == ref[f"{arch}|{mname}"]


def test_pshard_decision_matches_reference(reference):
    """``decide`` gives the entries the reference passes to
    ``with_sharding_constraint`` (divisible and > 1, else ``None``), and
    ``None`` everywhere where the reference makes no constraint."""
    ref = reference()["pshard"]
    try:
        for mname, mshape in MESHES.items():
            dp = tuple(a for a in ("pod", "data") if a in mshape)
            pshard.enable(FakeMesh(mshape), dp[0] if len(dp) == 1 else dp)
            for i, (shape, logical) in enumerate(PSHARD_CASES):
                got = pshard.decide(shape, logical)
                want = ref[f"{mname}|{i}"]
                if want is None:
                    assert all(e is None for e in got), (mname, shape)
                else:
                    assert _enc(got) == want, (mname, shape, logical)
    finally:
        pshard.disable()


def test_constrain_is_a_no_op_on_plain_tensors():
    """Disabled, or on a plain tensor, ``constrain`` returns its input
    and dispatches no aten op; a wrong number of names is refused."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    x = torch.ones(8, 4, 64)
    with Count():
        assert pshard.constrain(x, "dp", None, "tp") is x
        try:
            pshard.enable(FakeMesh({"data": 2, "model": 2}), "data")
            assert pshard.enabled()
            assert pshard.constrain(x, "dp", None, "tp") is x
        finally:
            pshard.disable()
    assert Count.n == 0 and not pshard.enabled()
    pshard.enable(FakeMesh({"data": 2, "model": 2}), "data")
    try:
        with pytest.raises(ValueError, match="logical names"):
            pshard.decide((8, 4), ("dp",))
    finally:
        pshard.disable()


def test_spec_helpers():
    """``local_shape`` divides each sharded dim by its axes' product;
    ``placements`` names one placement per mesh axis."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    assert shd.local_shape((80, 8192, 10240), (None, ("pod", "data"), "model"),
                           mesh) == (80, 256, 640)
    assert shd.placements(mesh, (None, ("pod", "data"), "model")) == [
        Shard(1), Shard(1), Shard(2)]
    assert shd.placements(mesh, ()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="does not divide"):
        shd.local_shape((10,), ("data",), mesh)
    assert shd.spec_tree("batch", {"tokens": _meta(64, 8)}, mesh) == \
        {"tokens": (("pod", "data"),)}
