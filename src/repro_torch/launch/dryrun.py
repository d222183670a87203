"""Multi-pod dry run on the ``meta`` device (port of
``repro/launch/dryrun.py``).

For every (architecture × input shape × mesh) cell the step function the
launchers run is run once on ``meta`` tensors, over the production mesh's
description (no devices), and the record the reference writes is written
under the same name:

* ``memory``: ``argument_bytes`` and ``output_bytes`` are the sums over the
  step's inputs and outputs of each leaf's per-device shard bytes under
  its spec (:mod:`repro_torch.launch.sharding`), the arguments XLA's
  ``memory_analysis`` counts per device; ``temp_bytes`` is ``null``: meta
  tensors hold no buffers, so a run cannot measure its temporaries.
* ``flops`` and ``bytes_accessed``: the run under a dispatch mode that
  counts each aten op's flops by ``FlopCounterMode``'s formulas and sums
  its operand and result bytes (views excluded). Every
  layer runs eagerly, so the count is exact at full depth; the record's
  per-device figures are the global count over the devices
  (``"per_device": "global / devices"``), and ``analysis`` keeps the
  reference's keys, taken from L=1 / L=2 runs as its ``_extrapolate`` does.
* ``collectives``: the port has no partitioner, so these are the
  collectives the FSDP/TP/EP layout implies, counted leaf by leaf from the
  specs in the reference's operand-bytes convention, ``"source":
  "layout"``: an all-gather of every dp-sharded weight per forward (again
  in remat's recompute), a reduce-scatter of its gradient, an all-reduce
  of every row-parallel site's output per forward, and two all-to-alls of
  the MoE dispatch buffer per layer per forward.

The reference's ``--constraints`` steers its partitioner; here it is
refused, since ``pshard.constrain`` acts only on DTensors and a meta run
holds none, so it could change no figure of the record
(``opts.constraints`` is always false).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh pod1 [--native-bits 8] [--kv-bits 8] \\
      [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod1 pod2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import runtime
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (dp_axes, dp_size, make_production_mesh,
                                     make_tiny_mesh)
from repro_torch.models.pshard import axis_size, mesh_axes

__all__ = ["run_cell", "measure_cell", "measure", "layout_collectives",
           "main"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _mesh_for(name: str):
    if name == "pod1":
        return make_production_mesh(multi_pod=False)
    if name == "pod2":
        return make_production_mesh(multi_pod=True)
    if name == "tiny":
        return make_tiny_mesh(2, 2)
    if name == "tiny2":
        return make_tiny_mesh(2, 2, multi_pod=True)
    raise ValueError(name)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Counter(TorchDispatchMode):
    """Counts each aten op, its flops by ``FlopCounterMode``'s formulas
    (``torch.utils.flop_counter.flop_registry``: matmuls, convolutions,
    attention) and the bytes of its operands and results (views move
    none). One dispatch mode does all three: ``FlopCounterMode`` itself
    also tries to decompose every op it has no formula for, an extra
    dispatch per op that changes no count."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def measure(fn, *args) -> dict:
    """``fn(*args)`` run once under :class:`_Counter` → ``flops``,
    ``bytes_accessed``, ``aten_ops`` (global: every device's work) and
    ``out``, its result."""
    c = _Counter()
    with c:
        out = fn(*args)
    return {"flops": float(c.flops), "bytes_accessed": float(c.bytes),
            "aten_ops": c.ops, "out": out}


def _sharded_bytes(tree, specs, mesh) -> int:
    leaves = shd.flatten_with_path(tree)
    spec_leaves = shd.flatten_with_path(specs)
    assert [p for p, _ in leaves] == [p for p, _ in spec_leaves]
    return sum(shd.local_bytes(t, s, mesh)
               for (_, t), (_, s) in zip(leaves, spec_leaves))


def _dp_group(spec, mesh) -> int:
    """Devices a leaf's dp-sharded dims span (1 if none)."""
    dp = set(dp_axes(mesh))
    n = 1
    for e in spec:
        for a in mesh_axes(e):
            if a in dp:
                n *= mesh.shape[a]
    return n


def layout_collectives(cfg, shape, mesh, params, pspecs) -> dict:
    """Per-device collective operand bytes implied by the layout (module
    docstring), keyed as the reference's ``collective_bytes``."""
    per_kind = {k: 0 for k in _COLLECTIVES}
    count = {k: 0 for k in _COLLECTIVES}
    train = shape.kind == "train"
    passes = 2 if (train and cfg.remat) else 1     # forward (+ recompute)
    leaves = shd.flatten_with_path(params)
    spec_leaves = dict(shd.flatten_with_path(pspecs))
    cdt_bytes = 2                                  # bf16 activations
    b = shape.global_batch
    b_local = b // dp_size(mesh) if b % dp_size(mesh) == 0 \
        and b >= dp_size(mesh) else b
    toks = b_local * (1 if shape.kind == "decode" else shape.seq_len)
    for path, t in leaves:
        spec = spec_leaves[path]
        g = _dp_group(spec, mesh)
        if g > 1:
            local = shd.local_bytes(t, spec, mesh)
            per_kind["all-gather"] += passes * local
            count["all-gather"] += passes
            if train:
                per_kind["reduce-scatter"] += local * g
                count["reduce-scatter"] += 1
        # a row-parallel site (output d_model) whose contraction dim is
        # model-sharded sums its partial outputs
        nd = t.dim()
        if (re.search(r"(attn_out|mlp/w_out|shared_out)/(w|wq/0)$", path)
                and len(spec) >= nd - 1 and "model" in mesh_axes(spec[nd - 2])):
            calls = t.shape[0] if path.startswith("layers/") else 1
            per_kind["all-reduce"] += (passes * calls * toks * cfg.d_model
                                       * cdt_bytes)
            count["all-reduce"] += passes * calls
    if cfg.moe is not None:
        E, k = cfg.moe.n_routed, cfg.moe.top_k
        t_all = b * (1 if shape.kind == "decode" else shape.seq_len)
        G = (math.gcd(cfg.moe.groups, b) if shape.kind == "decode"
             else cfg.moe.groups)
        tg = t_all // G
        cap = int(math.ceil(tg * k / E * cfg.moe.capacity_factor))
        dims = [G, E, cap, cfg.d_model]
        for i, ax in ((0, shd._dp_entry(mesh)), (1, "model")):
            n = axis_size(mesh, ax)
            if dims[i] % n == 0 and dims[i] > 1:
                dims[i] //= n
        buf = math.prod(dims) * cdt_bytes
        per_kind["all-to-all"] += 2 * passes * cfg.n_layers * buf
        count["all-to-all"] += 2 * passes * cfg.n_layers
    return {"source": "layout", "total": sum(per_kind.values()),
            "per_kind": per_kind, "count": count}


def _extrapolate(a1: dict, a2: dict, n_layers: int) -> dict:
    """per_layer = m(2) − m(1); total(L) = m(1) + (L−1)·per_layer, as the
    reference fits its unrolled lowerings (the eager step's counts are
    affine in depth, up to the scalar operands of the optimizer's runs of
    rows in ``bytes_accessed``)."""
    out = {}
    for key in ("flops", "bytes_accessed"):
        m1, m2 = a1[key], a2[key]
        per = max(0.0, m2 - m1)
        out[key] = m1 + (n_layers - 1) * per
        out[key + "_per_layer"] = per
    c1, c2 = a1["collectives"], a2["collectives"]
    per_kind = {}
    for k in c1["per_kind"]:
        per = max(0, c2["per_kind"][k] - c1["per_kind"][k])
        per_kind[k] = c1["per_kind"][k] + (n_layers - 1) * per
    out["collective_bytes"] = {"total": sum(per_kind.values()),
                               "per_kind": per_kind, "source": "layout"}
    return out


def measure_cell(cfg, shape, mesh, *, native_bits=None, kv_bits=16,
                 serve_layout=False, runs: dict | None = None) -> dict:
    """Build the cell's abstract inputs, run its step on meta, and count
    its per-device memory, work and collectives. ``runs``, if given,
    keeps each step's :func:`measure` by config and shape: its global
    counts do not depend on the mesh, so the meshes of one cell share one
    meta run."""
    engine = S.build_engine(cfg)
    key = (cfg, shape, native_bits, kv_bits, runtime.compute_dtype())

    def _measured(key, fn, *args) -> dict:
        if runs is None:
            return measure(fn, *args)
        if key not in runs:
            runs[key] = measure(fn, *args)
        return runs[key]
    pid = torch.empty((), dtype=torch.int32, device=S.META)
    t0 = time.time()
    if shape.kind == "train":
        params = S.abstract_params(cfg)
        opt = S.abstract_opt(params)
        batch = S.input_specs(cfg, shape)
        psp = shd.param_specs(params, mesh)
        osp = type(opt)(step=(), mu=shd.param_specs(opt.mu, mesh),
                        nu=shd.param_specs(opt.nu, mesh))
        args_b = (_sharded_bytes(params, psp, mesh)
                  + _sharded_bytes(opt, osp, mesh) + _nbytes(pid)
                  + _sharded_bytes(batch, shd.batch_specs(batch, mesh), mesh))
        t_build = time.time() - t0
        m = _measured(key, S.make_train_step_fn(cfg, engine), params, opt, 0,
                      batch)
        p_out, o_out, metrics = m["out"]
        out_b = (_sharded_bytes(p_out, psp, mesh)
                 + _sharded_bytes(o_out, osp, mesh) + _nbytes(metrics))
    elif shape.kind == "prefill":
        params = S.abstract_params(cfg, native_bits=native_bits)
        batch = S.input_specs(cfg, shape)
        psp = shd.param_specs(params, mesh, serve=serve_layout)
        args_b = (_sharded_bytes(params, psp, mesh) + _nbytes(pid)
                  + _sharded_bytes(batch, shd.batch_specs(batch, mesh), mesh))
        t_build = time.time() - t0
        m = _measured(key, S.make_prefill_fn(cfg, engine), params, 0, batch)
        out_b = _nbytes(m["out"])           # logits: no out spec, replicated
    else:
        params = S.abstract_params(cfg, native_bits=native_bits)
        caches = S.abstract_caches(cfg, shape, kv_bits=kv_bits)
        io = S.input_specs(cfg, shape)
        psp = shd.param_specs(params, mesh, serve=serve_layout)
        csp = shd.cache_specs(caches, mesh)
        args_b = (_sharded_bytes(params, psp, mesh) + _nbytes(pid)
                  + _sharded_bytes(io, shd.batch_specs(io, mesh), mesh)
                  + _sharded_bytes(caches, csp, mesh))
        t_build = time.time() - t0
        m = _measured(key, S.make_decode_fn(cfg, engine), params, 0,
                      io["tokens"], io["pos"], caches)
        logits, c_out = m["out"]
        out_b = _nbytes(logits) + _sharded_bytes(c_out, csp, mesh)
    return {"argument_bytes": args_b, "output_bytes": out_b,
            "flops": m["flops"], "bytes_accessed": m["bytes_accessed"],
            "aten_ops": m["aten_ops"], "build_s": t_build,
            "run_s": time.time() - t0 - t_build,
            "collectives": layout_collectives(cfg, shape, mesh, params, psp)}


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             native_bits: int | None, kv_bits: int,
             remat: bool | None = None, analysis: bool = True,
             swa_skip: bool = True, remat_policy: str = "nothing",
             serve_layout: bool = False, config_edit=None,
             verbose: bool = True, runs: dict | None = None) -> dict:
    """The reference's record for one cell (module docstring); ``runs``
    as :func:`measure_cell` takes it. ``opts.constraints`` is always
    false: activation constraints act on DTensors, and a meta run has
    none (ROADMAP.md Queue 3)."""
    # the card's compute dtype, as the reference lowers TPU numerics
    with runtime.use_compute_dtype(torch.bfloat16):
        return _run_cell(
            arch, shape_name, mesh_name, native_bits=native_bits,
            kv_bits=kv_bits, remat=remat, analysis=analysis,
            swa_skip=swa_skip, remat_policy=remat_policy,
            serve_layout=serve_layout, config_edit=config_edit,
            verbose=verbose, runs=runs)


def _run_cell(arch, shape_name, mesh_name, *, native_bits, kv_bits, remat,
              analysis, swa_skip, remat_policy, serve_layout,
              config_edit, verbose, runs) -> dict:
    shape = SHAPES[shape_name]
    cfg0 = get_config(arch)
    ok, why = shape_applicable(cfg0, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "native_bits": native_bits, "kv_bits": kv_bits,
           "opts": {"constraints": False, "swa_skip": swa_skip,
                    "remat_policy": remat_policy, "serve_layout": serve_layout}}
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name}: SKIP ({why})")
        return rec

    mesh = _mesh_for(mesh_name)
    cfg = S.adapt_config(cfg0, shape, dp_size(mesh))
    cfg = dataclasses.replace(cfg, swa_block_skip=swa_skip,
                              remat_policy=remat_policy)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if config_edit is not None:
        cfg = config_edit(cfg)
    kw = dict(native_bits=native_bits, kv_bits=kv_bits,
              serve_layout=serve_layout, runs=runs)
    c = measure_cell(cfg, shape, mesh, **kw)
    n_dev = mesh.size
    prod = dict(
        flops=c["flops"] / n_dev,
        bytes_accessed=c["bytes_accessed"] / n_dev,
        memory=dict(argument_bytes=c["argument_bytes"],
                    output_bytes=c["output_bytes"], temp_bytes=None),
        collectives=c["collectives"],
        hlo_lines=None,
        per_device="global / devices (flops, bytes_accessed); per-device "
                   "shards (memory); layout-derived (collectives)",
        flops_global=c["flops"], bytes_accessed_global=c["bytes_accessed"],
        aten_ops=c["aten_ops"],
        temp_bytes_note="not measurable on meta tensors (no buffers)",
    )
    if analysis:
        meas = []
        for n_layers in (1, 2):
            cl = measure_cell(dataclasses.replace(cfg, n_layers=n_layers),
                              shape, mesh, **kw)
            meas.append({"flops": cl["flops"] / n_dev,
                         "bytes_accessed": cl["bytes_accessed"] / n_dev,
                         "collectives": cl["collectives"]})
        rec["analysis"] = _extrapolate(meas[0], meas[1], cfg.n_layers)
    rec.update(status="ok", devices=n_dev, lower_s=round(c["build_s"], 2),
               compile_s=round(c["run_s"], 2), production=prod)
    if verbose:
        a = rec.get("analysis", {})
        flops = a.get("flops", prod["flops"])
        coll = a.get("collective_bytes", prod["collectives"])["total"]
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
              f"(inputs {c['build_s']:.1f}s, meta run {c['run_s']:.1f}s, "
              f"flops/dev {flops:.3e}, coll/dev {coll / 2**30:.2f} GiB "
              f"(layout))")
        print("  memory (per device):", prod["memory"])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", nargs="+", default=["pod1"],
                    choices=["pod1", "pod2", "tiny", "tiny2"])
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch × shape) cell")
    ap.add_argument("--native-bits", type=int, default=None,
                    help="serve paths: native int weight storage (8 or 4)")
    ap.add_argument("--kv-bits", type=int, default=16, choices=[4, 8, 16])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="skip the L=1/L=2 runs")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--constraints", action="store_true",
                    help="refused: no partitioner acts on a meta run")
    ap.add_argument("--no-swa-skip", action="store_true",
                    help="baseline masked attention for SWA archs")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "dots"])
    ap.add_argument("--serve-layout", action="store_true",
                    help="pure-TP weight layout for serving (no FSDP gathers)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    if args.constraints:
        ap.error("--constraints has no effect on meta tensors: activation "
                 "constraints redistribute DTensors, and the port has no "
                 "partitioner for them to steer (ROADMAP.md Queue 3)")

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    runs: dict = {}                 # one meta run per (arch × shape)
    for arch, shape in cells:
        for mesh_name in args.mesh:
            tag = f"{arch}__{shape}__{mesh_name}"
            if args.native_bits:
                tag += f"__w{args.native_bits}"
            if args.kv_bits != 16:
                tag += f"__kv{args.kv_bits}"
            if args.tag:
                tag += f"__{args.tag}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        print(f"[dryrun] {tag}: cached, skip")
                        continue
            try:
                rec = run_cell(arch, shape, mesh_name,
                               native_bits=args.native_bits,
                               kv_bits=args.kv_bits,
                               remat=False if args.no_remat else None,
                               swa_skip=not args.no_swa_skip,
                               remat_policy=args.remat_policy,
                               serve_layout=args.serve_layout,
                               analysis=(mesh_name in ("pod1", "tiny")
                                         and not args.no_analysis),
                               runs=runs)
            except Exception as e:  # a failing cell is a bug — surface it
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                failures.append(tag)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
    if failures:
        raise SystemExit(f"dry-run FAILURES: {failures}")
    print("[dryrun] all requested cells OK")


if __name__ == "__main__":
    main()
