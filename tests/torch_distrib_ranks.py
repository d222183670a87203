"""The rank side of ``tests/test_torch_distrib.py``: what each spawned gloo
rank runs. No JAX here: a spawned rank imports only this module, torch
and the port. Each rank writes its results to ``<dir>/rank<r>.pt``."""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.distrib.pipeline import pipeline_forward, stage_split
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import device_mesh, make_tiny_mesh
from repro_torch.models import pshard
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.native import to_native
from repro_torch.optim.compression import CompressionState, compressed_psum


def nested(flat: dict) -> dict:
    """``{"a/b": arr}`` → ``{"a": {"b": arr}}``."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def toy_stage(sp, h):
    for w in sp["w"]:
        h = torch.tanh(h @ w)
    return h


def granite_inputs(d: str):
    """The reference's smoke params (as the port's tree), the A8-W8 bits
    row, and the tokens, from the reference's ``granite.npz``."""
    z = np.load(os.path.join(d, "granite.npz"))
    params = params_from_jax(nested({k[2:]: z[k] for k in z.files
                                     if k.startswith("p:")}), device="cpu")
    return params, z["bits"], torch.from_numpy(z["tokens"])


def granite_stage_fn(cfg, layer_bits, n_stages: int, s: int):
    n = cfg.n_layers // n_stages
    bits = layer_bits[s * n:(s + 1) * n]
    return lambda sp, xm: T.layer_stack(cfg, sp, bits, xm)


def run(rank: int, world: int, pg: str, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg}", rank=rank,
                            world_size=world)
    res: dict = {}
    pair = dist.new_group([0, 1])
    # the toy pipeline: 4 stages of tanh layers, 4 microbatches
    z = np.load(os.path.join(d, "toy.npz"))
    ws, x = torch.from_numpy(z["ws"]), torch.from_numpy(z["x"])
    staged = stage_split({"w": ws}, world)
    res["toy"] = pipeline_forward(toy_stage, staged[rank], x, n_microbatches=4)
    # granite smoke layers in 2 stages on ranks 0 and 1
    if rank < 2:
        cfg = get_smoke("granite-3-2b")
        params, bits, tokens = granite_inputs(d)
        _, _, layer_bits = T.split_bits(cfg, bits)
        x0, _, _ = T._embed_inputs(cfg, params, bits, {"tokens": tokens})
        stage = stage_split(params["layers"], 2)[rank]
        y = pipeline_forward(granite_stage_fn(cfg, layer_bits, 2, rank),
                             stage, x0, n_microbatches=2, group=pair)
        res["granite"] = T._norm(cfg, params["norm_f"], y)
    # compressed_psum over 4 ranks and over ranks 0 and 1
    c = np.load(os.path.join(d, "compress.npz"))
    for n in (4, 2):
        if rank >= n:
            continue
        def leaf(kind):
            return nested({k.split(":", 1)[1]: torch.from_numpy(c[k].copy())
                           for k in c.files if k.startswith(f"{kind}{rank}:")})
        mean, st = compressed_psum(leaf("g"), CompressionState(leaf("r")),
                                   leaf("u"),
                                   group=None if n == world else pair)
        res[f"psum{n}"] = (mean, st.residual)
    # DTensor: the smoke params laid out under param_specs on a 2 x 2 mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = make_tiny_mesh(2, 2)
    dm = device_mesh(mesh, "cpu")
    cfg = get_smoke("granite-3-2b")
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rows = []
    for tree in (p, to_native(p, 8)):
        specs = dict(shd.flatten_with_path(shd.param_specs(tree, mesh)))
        for path, t in shd.flatten_with_path(tree):
            dt = distribute_tensor(t, dm, shd.placements(mesh, specs[path]))
            rows.append((path, tuple(t.shape), tuple(dt.to_local().shape),
                         shd.local_shape(tuple(t.shape), specs[path], mesh),
                         bool(torch.equal(dt.full_tensor(), t))))
    res["dtensor"] = rows
    pshard.enable(mesh, "data")
    try:
        a = distribute_tensor(torch.randn(8, 4, 64), dm, [Replicate(),
                                                          Replicate()])
        one = distribute_tensor(torch.randn(1, 3, 5), dm,
                                [Replicate(), Replicate()])
        res["constrained"] = [
            [str(q) for q in pshard.constrain(a, "dp", None, "tp").placements],
            [str(q) for q in pshard.constrain(a, None, "tp", None).placements],
            pshard.constrain(a, None, None, None) is a,
            pshard.constrain(one, "dp", None, "tp") is one]
    finally:
        pshard.disable()
    torch.save(res, os.path.join(d, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
