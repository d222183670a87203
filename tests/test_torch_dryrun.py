"""The port's dry run on ``meta`` tensors against the reference's compiled
one (``repro.launch.dryrun``).

The reference runs once, in a subprocess on 8 host devices (the device
count set before jax imports): it lowers and compiles the step of each
small cell through ``dryrun._lower_step`` and reads ``_measure``'s memory
record, the shardings its compiler chose for the outputs the reference
leaves unspecified, its skip record, and an ``ok`` record's keys. The
port's ``argument_bytes`` must equal XLA's ``argument_size_in_bytes`` byte
for byte. Its ``output_bytes`` differ by two causes, both pinned here:
XLA's output size also counts the output tuple's table (8 bytes a leaf
when the step returns a tuple),
and the compiler shards outputs the reference leaves unspecified (prefill
and decode logits), which the port counts replicated."""
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import _one_thread  # noqa: F401

from repro_torch import runtime
from repro_torch.configs import Shape, get_config, get_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import dp_size

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ([("granite-3-2b", kind, kv, mesh) for mesh in ("tiny", "tiny2")
          for kind, kv in (("train", 16), ("prefill", 16), ("decode", 16),
                           ("decode", 8))]
         + [("qwen2-moe-a2.7b", "train", 16, "tiny")])
SEQ, BATCH = 64, 8

REF_SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["REPRO_DRYRUN_DEVICES"] = "8"
import jax, jax.numpy as jnp, numpy as np
from repro import runtime
from repro.configs import get_smoke
from repro.configs.common import Shape
from repro.launch import dryrun as D, specs as S
from repro.launch.mesh import dp_size

cells, seq, batch = json.loads(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
runtime.set_compute_dtype(jnp.bfloat16)
out = {"cells": {}}
for arch, kind, kv, mname in cells:
    shape = Shape(f"small_{kind}", seq, batch, kind)
    mesh = D._mesh_for(mname)
    cfg = S.adapt_config(get_smoke(arch), shape, dp_size(mesh))
    with mesh:
        c = D._lower_step(cfg, shape, mesh, native_bits=None,
                          kv_bits=kv).compile()
        mem = D._measure(c)["memory"]
    outs = jax.tree_util.tree_leaves(c.out_info)
    shs = jax.tree_util.tree_leaves(c.output_shardings)
    # outputs the reference passes no sharding for: prefill's logits,
    # decode's logits (first leaf), train's metrics (the last five)
    free = {"prefill": outs, "decode": outs[:1], "train": outs[-5:]}[kind]
    free_sh = {"prefill": shs, "decode": shs[:1], "train": shs[-5:]}[kind]
    unspec = 0
    for info, sh in zip(free, free_sh):
        item = np.dtype(info.dtype).itemsize
        unspec += (int(np.prod(info.shape))
                   - int(np.prod(sh.shard_shape(info.shape)))) * item
    out["cells"]["|".join(map(str, (arch, kind, kv, mname)))] = dict(
        mem, n_out=len(outs), unspec=unspec)
skip = D.run_cell("qwen2-72b", "long_500k", "tiny", native_bits=None,
                  kv_bits=16, verbose=False)
out["skip"] = skip
rec = D.run_cell("granite-3-2b", "decode_32k", "tiny", native_bits=None,
                 kv_bits=16, verbose=False,
                 config_edit=lambda c: dataclasses.replace(c, n_layers=2))

def keys(d, pre=""):
    ks = []
    for k, v in d.items():
        ks.append(pre + k)
        if isinstance(v, dict) and k not in ("per_kind", "count"):
            ks += keys(v, pre + k + ".")
    return ks
out["ok_keys"] = keys(rec)
json.dump(out, open(sys.argv[1], "w"))
"""


class _Run:
    """A subprocess started at once; ``result()`` waits for it."""

    def __init__(self, args, env):
        self.proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=env, cwd=REPO)
        self.out = None

    def result(self) -> str:
        if self.out is None:
            self.out, _ = self.proc.communicate(timeout=300)
        assert self.proc.returncode == 0, self.out
        return self.out


FULL = ("qwen2-72b", "qwen1.5-110b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and, beside it, the port's CLI on the
    full qwen2-72b and qwen1.5-110b train_4k cells (pod1, no analysis),
    all started together."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {"ref": _Run([sys.executable, "-c", REF_SCRIPT,
                          str(tmp / "ref.json"), json.dumps(CELLS),
                          str(SEQ), str(BATCH)], env)}
    for arch in FULL:
        procs[arch] = _Run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", arch, "--shape", "train_4k", "--mesh",
                            "pod1", "--no-analysis", "--out", str(tmp)], env)
    yield tmp, procs
    for r in procs.values():
        if r.proc.poll() is None:
            r.proc.kill()


@pytest.fixture(scope="module")
def reference(runs):
    tmp, procs = runs
    box = {}

    def get():
        if "data" not in box:
            procs["ref"].result()
            box["data"] = json.loads((tmp / "ref.json").read_text())
        return box["data"]
    return get


def _keys(d, pre=""):
    ks = []
    for k, v in d.items():
        ks.append(pre + k)
        if isinstance(v, dict) and k not in ("per_kind", "count"):
            ks += _keys(v, pre + k + ".")
    return ks


def _small_cell(arch, kind, kv, mname):
    shape = Shape(f"small_{kind}", SEQ, BATCH, kind)
    mesh = D._mesh_for(mname)
    cfg = S.adapt_config(get_smoke(arch), shape, dp_size(mesh))
    with runtime.use_compute_dtype(torch.bfloat16):
        return D.measure_cell(cfg, shape, mesh, kv_bits=kv)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(map(str, c)))
def test_memory_matches_xla(reference, cell):
    """``argument_bytes`` = XLA's ``argument_size_in_bytes``; ``output_bytes``
    = XLA's ``output_size_in_bytes`` less 8 bytes per output leaf where the
    result is a tuple (the tuple's table) plus what the compiler's sharding of the unspecified
    outputs saved (the port counts them replicated)."""
    ref = reference()["cells"]["|".join(map(str, cell))]
    got = _small_cell(*cell)
    assert got["argument_bytes"] == ref["argument_bytes"]
    table = 8 * ref["n_out"] if ref["n_out"] > 1 else 0
    assert got["output_bytes"] == ref["output_bytes"] - table + ref["unspec"]


def test_forward_flops_equal_a_hand_count():
    """The granite smoke prefill step's flops are its products counted by
    hand: per layer the four linears and the two attention contractions
    over every key block (S × S, a ragged last block included), then the
    tied head on the last position."""
    cfg = get_smoke("granite-3-2b")
    b, s = 2, 48                         # blocks of 32: one full, one of 16
    shape = Shape("p", s, b, "prefill")
    with runtime.use_compute_dtype(torch.bfloat16):
        got = D.measure_cell(cfg, shape, D._mesh_for("tiny"))["flops"]
    d, h, hkv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd,
                            cfg.d_ff, cfg.vocab)
    linears = d * (h + 2 * hkv) * hd + h * hd * d + d * 2 * ff + ff * d
    layer = 2 * b * s * linears + 4 * b * h * s * s * hd
    assert got == cfg.n_layers * layer + 2 * b * d * v


def test_counter_matches_flop_counter_mode():
    """The dry run's one dispatch mode counts what
    ``FlopCounterMode`` counts, on a training step with remat."""
    from torch.utils.flop_counter import FlopCounterMode
    import dataclasses
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), remat=True)
    shape = Shape("t", 32, 4, "train")
    eng = S.build_engine(cfg)

    def args():
        p = S.abstract_params(cfg)
        return p, S.abstract_opt(p), 0, S.input_specs(cfg, shape)
    with runtime.use_compute_dtype(torch.bfloat16):
        m = D.measure(S.make_train_step_fn(cfg, eng), *args())
        f = FlopCounterMode(display=False)
        with f:
            S.make_train_step_fn(cfg, eng)(*args())
    assert m["flops"] == f.get_total_flops() > 0
    assert m["bytes_accessed"] > 0 and m["aten_ops"] > 0


def test_skip_record_carries_the_reference_reason(reference):
    got = D.run_cell("qwen2-72b", "long_500k", "tiny", native_bits=None,
                     kv_bits=16, verbose=False)
    assert got == reference()["skip"]
    assert got["status"] == "skipped" and "sub-quadratic" in got["reason"]


def test_cli_writes_the_reference_record(reference, tmp_path):
    """``python -m repro_torch.launch.dryrun`` writes ``<arch>__<shape>__
    <mesh>[__kv8].json`` with every key of the reference's ``ok`` record
    (production, memory, analysis), ``temp_bytes`` null with its note,
    and the collectives labelled as derived from the layout. It refuses
    ``--constraints``, which no partitioner could act on here, and records
    that no constraint was applied."""
    argv = ["--arch", "granite-3-2b", "--shape", "decode_32k", "--mesh",
            "tiny", "--kv-bits", "8", "--out", str(tmp_path)]
    with pytest.raises(SystemExit):
        D.main(argv + ["--constraints"])
    assert not list(tmp_path.iterdir())
    D.main(argv)
    rec = json.loads((tmp_path / "granite-3-2b__decode_32k__tiny__kv8.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 4
    assert rec["opts"]["constraints"] is False
    missing = set(reference()["ok_keys"]) - set(_keys(rec))
    assert not missing, missing
    prod = rec["production"]
    assert prod["memory"]["temp_bytes"] is None and prod["temp_bytes_note"]
    assert prod["collectives"]["source"] == "layout"
    assert prod["flops"] == prod["flops_global"] / 4 > 0
    a = rec["analysis"]
    assert a["flops"] == pytest.approx(prod["flops"], rel=1e-12)
    assert a["bytes_accessed"] == pytest.approx(prod["bytes_accessed"],
                                                rel=1e-9)


@pytest.mark.parametrize("arch", FULL)
def test_full_config_trains_on_meta(runs, arch):
    """The published qwen2-72b and qwen1.5-110b (290.8 GB / 444.8 GB of f32
    masters) take a full-depth training step at train_4k on the 256-device
    mesh, on meta, through the CLI: status ok, per-device arguments = f32
    params + Adam's two moments sharded, flops of a forward, a recompute
    and a backward, the layout's collectives."""
    tmp, procs = runs
    log = procs[arch].result()
    assert "all requested cells OK" in log
    rec = json.loads((tmp / f"{arch}__train_4k__pod1.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert "analysis" not in rec
    prod = rec["production"]
    mem = prod["memory"]
    assert 3 * 2**30 < mem["argument_bytes"] < 6 * 2**30
    assert mem["output_bytes"] < mem["argument_bytes"]
    n = S.abstract_params(get_config(arch))
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(n))
    tokens = 256 * 4096
    # 6·N·T for forward + backward, 2·N·T more for remat's recompute
    assert 6 * n_params * tokens < prod["flops_global"] < 10 * n_params * tokens
    coll = prod["collectives"]["per_kind"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["all-reduce"] > 0 and coll["all-to-all"] == 0


def _kernel_inputs(gen):
    """Small CPU inputs of K1, K2, K4 (one row of 5 keys, blocks of 4)."""
    b, hkv, hg, d, bs, nb, w = 2, 2, 2, 16, 4, 5, 3
    bt = torch.tensor([[0, 1], [2, -1]], dtype=torch.int32)
    tidx = torch.arange(nb * bs, dtype=torch.int32).reshape(nb, bs) % 8
    pool = torch.randn(nb, bs, hkv, d, generator=gen).bfloat16()  # kv16
    scale = torch.rand(b, hkv, generator=gen) + 0.1
    pos = torch.tensor([5, 2], dtype=torch.int32)
    paged = (torch.randn(b, hkv, hg, d, generator=gen), pool, pool.clone(),
             scale, scale.clone(), tidx, bt, pos)
    multi = (torch.randn(b, w, hkv, hg, d, generator=gen), pool,
             pool.clone(), torch.rand(b, w, hkv, generator=gen),
             torch.rand(b, w, hkv, generator=gen), tidx, bt, pos)
    k8 = torch.randint(-127, 128, (b, 8, hkv, d), generator=gen,
                       dtype=torch.int8)
    qkv = (torch.randn(b, hkv, hg, d, generator=gen), k8, k8.clone(),
           scale, scale.clone(),
           torch.tensor([[5, 5], [8, 8]], dtype=torch.int32))
    return paged, multi, qkv


def test_meta_tensors_take_the_plain_version():
    """Each kernel wrapper given ``meta`` tensors returns what its plain
    version returns on the CPU, in shape and dtype, and counts no launch."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    from repro_torch.core.qtypes import pack_int4
    gen = torch.Generator().manual_seed(0)
    paged, multi, qkv = _kernel_inputs(gen)
    x = torch.randn(6, 32, generator=gen)
    w8 = torch.randint(-127, 128, (32, 24), generator=gen, dtype=torch.int8)
    w4 = pack_int4(torch.randint(-7, 8, (32, 24), generator=gen,
                                 dtype=torch.int8))
    sc = torch.rand(24, generator=gen)

    def meta(args):
        return tuple(a.to("meta") for a in args)
    cases = [
        (AQ.aquant, (x,), {}),
        (AQ.aquant, (x,), {"out_dtype": torch.bfloat16}),
        (AQ.aquant, (x.bfloat16(),), {"bits": 4}),
        (QM.qmatmul, (x, w8, sc), {"bits": 8}),
        (QM.qmatmul, (x.bfloat16(), w4, sc), {"bits": 4}),
        (PA.paged_attention, paged, {"bits": 16}),
        (PA.paged_attention_multi, multi, {"bits": 16}),
        (QK.qkv_attention, qkv, {}),
    ]
    counters = [AQ.aquant, QM.qmatmul, PA.paged_attention,
                PA.paged_attention_multi, QK.qkv_attention]
    before = [f.launches for f in counters]
    for fn, args, kw in cases:
        want = fn(*args, **kw)
        got = fn(*meta(args), **kw)
        assert got.device.type == "meta"
        assert (got.shape, got.dtype) == (want.shape, want.dtype), fn
    assert [f.launches for f in counters] == before


def test_meta_calls_refuse_what_the_card_refuses():
    """A meta call is validated as a CUDA one: an operand the kernel would
    refuse on the card (a dtype, an output type, a shape) is refused on
    meta too, before the plain version runs."""
    from repro_torch.kernels import aquant as AQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import qkv_attention as QK
    from repro_torch.kernels import qmatmul as QM
    gen = torch.Generator().manual_seed(0)
    paged, multi, qkv = _kernel_inputs(gen)
    x = torch.randn(6, 32, generator=gen)
    w8 = torch.randint(-127, 128, (32, 24), generator=gen, dtype=torch.int8)
    sc = torch.rand(24, generator=gen)

    def swap(args, i, t):
        return tuple((t if j == i else a).to("meta")
                     for j, a in enumerate(args))
    cases = [
        (AQ.aquant, (x.bfloat16().to("meta"),),
         {"out_dtype": torch.float32}, "bf16 from f32"),
        (QM.qmatmul, swap((x, w8, sc), 2, sc.double()), {"bits": 8},
         "scale must be"),
        (QM.qmatmul, swap((x, w8, sc), 1, w8[:16]), {"bits": 8},
         "w_q must have shape"),
        (PA.paged_attention, swap(paged, 1, paged[1].float()), {"bits": 16},
         "k_pool must be"),
        (PA.paged_attention, swap(paged, 7, paged[7].long()), {"bits": 16},
         "pos must be"),
        (PA.paged_attention_multi, swap(multi, 3, multi[3][:, :1]),
         {"bits": 16}, "k_ladder must have shape"),
        (QK.qkv_attention, swap(qkv, 5, qkv[5].long()), {}, "lengths must"),
    ]
    counters = [AQ.aquant, QM.qmatmul, PA.paged_attention,
                PA.paged_attention_multi, QK.qkv_attention]
    before = [f.launches for f in counters]
    for fn, args, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(*args, **kw)
    assert [f.launches for f in counters] == before
