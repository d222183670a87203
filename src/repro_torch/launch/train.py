"""Training launcher (port of ``repro/launch/train.py``), on one device.

Joint QAT over the paper's six profiles (one profile per step, rotating
``step % 6``; ``Mixed`` drops the inner third of the layers to A4-W4), the
reference's AdamW, the deterministic token stream, checkpoint/restart,
straggler monitoring and SIGTERM preemption (:mod:`repro_torch.train.
loop`), with optional int8 gradient compression and error feedback around
the optimizer. The default is the reduced smoke config; ``--full`` trains
the published one. Runs on the GPU unless ``--device cpu`` is given; with
no GPU and no ``--device`` it raises. On the card the model computes in
bf16 over f32 masters, with K5 fake-quantizing every weight site.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --steps 50 --ckpt-dir /tmp/ckpt [--full] [--profile A8-W8] \\
      [--grad-compression] [--device cpu]

The step updates the parameters and moments in place (bitwise the
reference's functional update). On the card it replays from one CUDA graph
per profile id (:class:`~repro_torch.train.graphs.TrainGraphs`; the
reference jits it once with the profile id as data), the batch staged
from the host with one pinned copy. This launcher runs on one device, as
the reference's does; its step is the one the dry run runs on ``meta``
over the production meshes' shardings (``launch/specs.py``,
``launch/dryrun.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.core.engine import AdaptiveEngine, QuantIndex
from repro_torch.core.profiles import paper_profiles
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as T
from repro_torch.optim.adam import AdamConfig, adam_update_
from repro_torch.optim.compression import (compress_tree, decompress_tree,
                                           init_error_feedback)
from repro_torch.runtime import resolve_device
from repro_torch.train.loop import TrainConfig, train, value_and_grad

__all__ = ["parse_args", "Training", "setup", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--profile", default=None,
                    help="train a single profile (default: rotate all, joint QAT)")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Training:
    """Everything :func:`train` is called with, built by :func:`setup`."""
    cfg: T.ModelConfig
    device: torch.device
    params: dict
    engine: AdaptiveEngine
    loss_fn: Callable
    data_at: Callable[[int], dict]     # the step's batch, on the host
    step_factory: Callable
    train_cfg: TrainConfig
    adam_cfg: AdamConfig
    ef: dict                      # {"state": CompressionState or None}

    def _take_params(self) -> dict:
        params, self.params = self.params, None
        return params

    def run(self, log: Callable[[str], None] = print,
            graphs: Optional[bool] = None) -> dict:
        """:func:`~repro_torch.train.loop.train` on this setup, once (one
        training lifetime): the initial parameters are handed over (the
        in-place step trains them where they lie; a resume drops them
        before the checkpoint's are read), and the trained ones are in the
        result. ``graphs``: see ``train`` (default: on for a CUDA
        device)."""
        if self.params is None:
            raise RuntimeError("Training.run: the parameters were handed "
                               "over to an earlier run; call setup again")
        return train(self._take_params(), self.loss_fn, self.data_at,
                     self.train_cfg, self.adam_cfg,
                     step_factory=self.step_factory, log=log, graphs=graphs)


def _step_factory(ef: dict, device: torch.device):
    """The launcher's step: the loss and its gradients, then the AdamW
    update in place (:func:`~repro_torch.optim.adam.adam_update_`, bitwise
    the reference's functional update). With error feedback on
    (``ef["state"]``) the gradients first go through compress →
    decompress, the int8 wire format of the reference's multi-pod
    all-reduce (error feedback shown on one device). Each step draws its
    noise from the step's generator reseeded 0, as the reference passes
    ``PRNGKey(0)`` at every step; the step names it in its ``generators``,
    so a replayed graph draws the same noise. Each raw gradient is dropped
    once its leaf is compressed, each int8 leaf once it is read."""

    def factory(loss_fn, acfg):
        gen = (torch.Generator(device=device) if ef["state"] is not None
               else None)

        def step(params, opt, batch):
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
            if gen is not None:
                gen.manual_seed(0)
                q, s, ef["state"] = compress_tree(grads, ef["state"], gen,
                                                  release=True)
                grads = decompress_tree(q, s, release=True)
            params, opt, om = adam_update_(acfg, grads, opt, params)
            return params, opt, {"loss": loss, **metrics, **om}
        step.generators = () if gen is None else (gen,)
        return step
    return factory


def setup(args: argparse.Namespace) -> Training:
    """The model, engine, data and step of a launch (no step run yet).
    Refuses a frontend arch (vision or audio), as the reference does."""
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if cfg.frontend is not None:
        raise SystemExit("token-LM launcher: pick a text arch "
                         "(audio/vlm archs train via tests/benchmarks)")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, device=dev)

    names = T.quant_layer_names(cfg)
    lo, hi = cfg.n_layers // 3, 2 * cfg.n_layers // 3
    inner = [n for n in names
             if n.startswith("L") and lo <= int(n[1:].split(".")[0]) < hi]
    profs = paper_profiles(names, inner_layers=inner)
    engine = AdaptiveEngine(tuple(profs), QuantIndex(names),
                            lambda p, br, b: T.train_loss(p, cfg, br, b))
    pid_fixed = engine.profile_id(args.profile) if args.profile else None

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                         seed=args.seed)
    ef: dict[str, Any] = {"state": init_error_feedback(params)
                          if args.grad_compression else None}

    def loss_fn(params, batch):
        return engine(params, batch["profile_id"],
                      {"tokens": batch["tokens"], "labels": batch["labels"]})

    def data_at(step):
        b = stream.batch_at(step)
        pid = pid_fixed if pid_fixed is not None else step % len(profs)
        return {"tokens": torch.from_numpy(b["tokens"]),
                "labels": torch.from_numpy(b["labels"]),
                "profile_id": pid}

    return Training(
        cfg=cfg, device=dev, params=params, engine=engine, loss_fn=loss_fn,
        data_at=data_at, step_factory=_step_factory(ef, dev),
        train_cfg=TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                              ckpt_every=max(1, args.steps // 4),
                              log_every=5),
        adam_cfg=AdamConfig(lr=args.lr, total_steps=args.steps,
                            warmup_steps=10),
        ef=ef)


def main(argv=None) -> dict:
    args = parse_args(argv)
    run = setup(args)
    print(f"[train] {run.cfg.name}: {T.param_count(run.params)/1e6:.1f}M "
          f"params on {run.device}")
    out = run.run()
    h = out["history"]
    if h:
        print(f"[train] done: loss {h[0]:.3f} → {h[-1]:.3f} "
              f"({len(h)} steps, {len(out['stragglers'])} stragglers flagged)")
    else:
        print(f"[train] done: nothing to run (resumed at step "
              f"{out['last_step'] + 1} of {args.steps})")
    return out


if __name__ == "__main__":
    main()
