"""The port's checkpoint manager against the JAX package's, in one on-disk
format: every case of ``tests/test_checkpoint.py`` on torch tensors and on
numpy arrays (``device=`` where the reference takes ``shardings=``), a bf16
leaf bitwise, and directories crossing between the packages both ways
with equal keys, dtypes, crc32 and bytes."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JM
from repro_torch.checkpoint.manager import (CheckpointIntegrityError,
                                            CheckpointManager, latest_step,
                                            restore, save)

KINDS = ["torch", "numpy"]


def _arr(kind, x):
    x = np.asarray(x)
    return torch.from_numpy(x.copy()) if kind == "torch" else x


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(kind, seed=0):
    rng = np.random.default_rng(seed)
    return {"layers": {"w": _arr(kind, rng.standard_normal((4, 8))
                                 .astype(np.float32)),
                       "b": _arr(kind, np.zeros(8, np.float32))},
            "step_scalar": _arr(kind, np.asarray(3, np.int32))}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return (torch.zeros_like(tree) if isinstance(tree, torch.Tensor)
            else np.zeros_like(tree))


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip_bit_exact(tmp_path, kind):
    t = _tree(kind)
    save(str(tmp_path), 5, t, {"note": "x"})
    out, meta = restore(str(tmp_path), _zeros_like(t), device="cpu")
    assert meta["step"] == 5 and meta["metadata"]["note"] == "x"
    for a, b in zip(_leaves(t), _leaves(out)):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert b.dtype == torch.from_numpy(_np(a)).dtype
        np.testing.assert_array_equal(_np(a), b.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_latest_and_retention(tmp_path, kind):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(kind)
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    assert mgr.latest_step() == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.endswith(".DONE"))
    assert len(kept) == 2                     # keep-N retention


@pytest.mark.parametrize("kind", KINDS)
def test_torn_write_ignored(tmp_path, kind):
    t = _tree(kind)
    save(str(tmp_path), 1, t)
    # a torn write: a step directory without its commit marker
    os.makedirs(tmp_path / "step_000000002")
    with open(tmp_path / "step_000000002" / "arrays.npz", "wb") as f:
        f.write(b"garbage")
    assert latest_step(str(tmp_path)) == 1    # the torn step is invisible
    _, meta = restore(str(tmp_path), _zeros_like(t), device="cpu")
    assert meta["step"] == 1


@pytest.mark.parametrize("kind", KINDS)
def test_restore_shape_mismatch_raises(tmp_path, kind):
    save(str(tmp_path), 1, {"w": _arr(kind, np.zeros((2, 2), np.float32))})
    with pytest.raises(ValueError):
        restore(str(tmp_path), {"w": _arr(kind, np.zeros((3, 3)))},
                device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_missing_leaf_raises(tmp_path, kind):
    save(str(tmp_path), 1, {"w": _arr(kind, np.zeros((2, 2), np.float32))})
    with pytest.raises(KeyError):
        restore(str(tmp_path), {"w": _arr(kind, np.zeros((2, 2))),
                                "extra": _arr(kind, np.zeros(1))},
                device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_restore_places_leaves_on_device(tmp_path, kind):
    """``device=`` places every leaf (the reference's elastic ``shardings=``
    path: same bytes, another placement); without a template it turns the
    host arrays into tensors there."""
    t = {"w": _arr(kind, np.arange(16.0, dtype=np.float32).reshape(4, 4))}
    save(str(tmp_path), 2, t)
    out, _ = restore(str(tmp_path), _zeros_like(t), device="cpu")
    np.testing.assert_array_equal(out["w"].numpy(), _np(t["w"]))
    assert out["w"].device == torch.device("cpu")
    bare, _ = restore(str(tmp_path), device="cpu")
    assert isinstance(bare["w"], torch.Tensor)
    np.testing.assert_array_equal(bare["w"].numpy(), _np(t["w"]))


@pytest.mark.parametrize("kind", KINDS)
def test_manifest_detects_silent_corruption(tmp_path, kind):
    """A bit-rotted leaf fails its crc32: strict restore raises
    CheckpointIntegrityError naming it; strict=False drops it, lists it in
    meta["corrupt_keys"] and keeps every healthy leaf."""
    t = {"good": _arr(kind, np.arange(8.0, dtype=np.float32)),
         "bad": _arr(kind, np.ones((3, 3), np.float32))}
    save(str(tmp_path), 1, t)
    sdir = tmp_path / "step_000000001"
    with np.load(sdir / "arrays.npz") as z:
        flat = {n: z[n] for n in z.files}
    flat["bad"] = flat["bad"] + 1.0           # same shape and dtype
    np.savez(sdir / "arrays.npz", **flat)
    with pytest.raises(CheckpointIntegrityError, match="bad"):
        restore(str(tmp_path))
    out, meta = restore(str(tmp_path), strict=False)
    assert meta["corrupt_keys"] == ["bad"]
    assert "bad" not in out
    assert isinstance(out["good"], np.ndarray)    # host arrays, no template
    np.testing.assert_array_equal(out["good"], np.arange(8.0))


@pytest.mark.parametrize("kind", KINDS)
def test_restore_falls_back_when_gc_wins_race(tmp_path, kind):
    """A marker whose payload vanished (retention removes the marker first,
    but a lister may hold a stale listing) falls back to the next older
    committed step; an explicit step fails loudly."""
    save(str(tmp_path), 1, {"w": _arr(kind, np.zeros(4, np.float32))})
    save(str(tmp_path), 2, {"w": _arr(kind, np.ones(4, np.float32))})
    shutil.rmtree(tmp_path / "step_000000002")
    assert os.path.exists(tmp_path / "step_000000002.DONE")
    out, meta = restore(str(tmp_path))
    assert meta["step"] == 1
    np.testing.assert_array_equal(out["w"], np.zeros(4))
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), step=2)


# ---------------------------------------------------------------------------
# bf16 and the cross-package format
# ---------------------------------------------------------------------------

def _bf16_bits(seed=0):
    """bf16 values with edges: ±0, ±inf, a NaN, the smallest subnormal."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(29).astype(np.float32))
    x = torch.cat([x, torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                                    float("nan"), 9.2e-41])])
    return x.to(torch.bfloat16).reshape(5, 7)


def test_bf16_leaf_roundtrips_bitwise(tmp_path):
    """numpy has no bf16: the leaf is stored as the int16 view of its bits,
    its manifest says "bfloat16" (the reference's ``str(dtype)``), and it
    restores bit for bit with a template and without one."""
    w = _bf16_bits()
    save(str(tmp_path), 1, {"w": w, "f": torch.ones(3)})
    meta = json.loads((tmp_path / "step_000000001" / "meta.json")
                      .read_text())
    assert meta["manifest"]["w"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_000000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.int16
    bits = w.view(torch.int16)
    out, _ = restore(str(tmp_path), {"w": torch.zeros(5, 7,
                                                      dtype=torch.bfloat16),
                                     "f": torch.zeros(3)}, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), bits)
    bare, _ = restore(str(tmp_path))
    assert bare["w"].dtype == torch.bfloat16
    assert torch.equal(bare["w"].view(torch.int16), bits)


def _ref_tree():
    k = jax.random.PRNGKey(3)
    return {"rows": {"7": {"mk": jax.random.normal(k, (2, 5, 2, 4)),
                           "ksc": jnp.full((2, 2), 0.125, jnp.float32)}},
            "ids": jnp.arange(6, dtype=jnp.int32),
            "seq": [jnp.ones(3), (jnp.zeros((1, 2), jnp.int32),)]}


def _same_step_files(a, b):
    """Two committed step directories hold the same keys, manifest (shape,
    dtype, crc32), metadata and bytes."""
    ma = json.loads((a / "meta.json").read_text())
    mb = json.loads((b / "meta.json").read_text())
    for key in ("step", "keys", "manifest", "metadata", "process_count"):
        assert ma[key] == mb[key], key
    with np.load(a / "arrays.npz") as za, np.load(b / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files) == ma["keys"]
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            assert za[k].tobytes() == zb[k].tobytes(), k


def test_reference_directory_restores_in_port(tmp_path):
    t = _ref_tree()
    JM.save(str(tmp_path / "ref"), 4, t, {"round": 9})
    out, meta = restore(str(tmp_path / "ref"))
    flat = JM._flatten(t)
    assert meta["keys"] == sorted(flat) and meta["process_count"] == 1
    assert meta["metadata"] == {"round": 9} and meta["corrupt_keys"] == []
    got = {"rows/7/mk": out["rows"]["7"]["mk"],
           "rows/7/ksc": out["rows"]["7"]["ksc"], "ids": out["ids"],
           "seq/0": out["seq"]["0"], "seq/1/0": out["seq"]["1"]["0"]}
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes()
        assert meta["manifest"][k]["crc32"] == JM._crc(v)
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype={
        "float32": torch.float32, "int32": torch.int32}[str(a.dtype)]), t)
    typed, _ = restore(str(tmp_path / "ref"), like, device="cpu")
    np.testing.assert_array_equal(typed["rows"]["7"]["mk"].numpy(),
                                  np.asarray(t["rows"]["7"]["mk"]))
    assert typed["seq"][1][0].dtype == torch.int32
    # the port writes the same step, file for file
    save(str(tmp_path / "port"), 4,
         jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t),
         {"round": 9})
    _same_step_files(tmp_path / "ref" / "step_000000004",
                     tmp_path / "port" / "step_000000004")


def test_port_directory_restores_in_reference(tmp_path):
    rng = np.random.default_rng(5)
    t = {"rows": {"3": {"mk": torch.from_numpy(
                            rng.standard_normal((2, 9, 2, 4))
                            .astype(np.float32)),
                        "va": torch.rand(2, 2)}},
         "ids": np.arange(5, dtype=np.int32)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, t, {"n": step})
    out, meta = JM.restore(str(tmp_path))
    assert meta["step"] == 3 and meta["metadata"] == {"n": 3}
    assert meta["corrupt_keys"] == []
    np.testing.assert_array_equal(out["rows"]["3"]["mk"],
                                  t["rows"]["3"]["mk"].numpy())
    np.testing.assert_array_equal(out["ids"], t["ids"])
    like = {"rows": {"3": {"mk": jnp.zeros((2, 9, 2, 4)),
                           "va": jnp.zeros((2, 2))}},
            "ids": jnp.zeros(5, jnp.int32)}
    typed, _ = JM.restore(str(tmp_path), like)
    np.testing.assert_array_equal(np.asarray(typed["rows"]["3"]["va"]),
                                  t["rows"]["3"]["va"].numpy())
    assert JM.latest_step(str(tmp_path)) == 3
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.endswith(".DONE")) == ["step_000000002.DONE",
                                              "step_000000003.DONE"]


def test_reference_bf16_leaf_reads_in_port(tmp_path):
    """The reference writes a bf16 leaf as raw ``V2`` records (and cannot
    restore it itself: its manifest check sees ``|V2``); the port reads
    those bits back as bf16, bitwise."""
    w = _bf16_bits(1)
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    JM.save(str(tmp_path), 1, {"w": jw})
    with pytest.raises(JM.CheckpointIntegrityError):
        JM.restore(str(tmp_path))
    out, _ = restore(str(tmp_path))
    assert out["w"].dtype == torch.bfloat16
    assert np.array_equal(out["w"].view(torch.int16).numpy(),
                          np.asarray(jw).view(np.int16))
