"""Training loop with QAT, checkpoint/restart fault tolerance, and
straggler monitoring (port of ``repro/train/loop.py``).

The loop is stateless between steps apart from ``(params, opt_state)``:
the data pipeline is a pure function of the step index
(:meth:`repro_torch.data.tokens.TokenStream.batch_at`), so a restart from
a checkpoint replays bit-exactly.

* **checkpoint/restart** — :class:`~repro_torch.checkpoint.manager.
  CheckpointManager` with atomic commits; a restart resumes from the newest
  committed step (``(params, AdamState)``, in the reference's on-disk
  format, so either package resumes the other's directory). The restore
  reads into new tensors against a template on the ``meta`` device, so
  no moments are allocated before it and, where the caller has handed
  ``params`` over, the initial weights are released before the
  checkpoint's arrive.
* **straggler detection** — :class:`StragglerMonitor` flags steps slower
  than ``mean + k·σ`` of the recent window (and 1.5× the mean).
* **preemption** — SIGTERM sets a flag; the loop checkpoints and exits.
* **failure injection** — ``fail_at_step`` raises once after that step's
  update, before its checkpoint.

A step is eager PyTorch: the loss, ``torch.autograd.grad`` over the
parameter leaves, then the AdamW update (no jit, no ``torch.compile``).
:func:`make_train_step` is the reference's functional step; the launcher
builds its own in-place one (:mod:`repro_torch.launch.train`), which a
multi-GB model needs to fit.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init,
                                    adam_update)

__all__ = ["TrainConfig", "StragglerMonitor", "train", "make_train_step",
           "value_and_grad"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    # failure injection for fault-tolerance tests: raise at this step once
    fail_at_step: Optional[int] = None


class StragglerMonitor:
    """Flags abnormally slow steps (straggler detection at the host level)."""

    def __init__(self, window: int = 20, k_sigma: float = 3.0, min_steps: int = 5):
        self.window = window
        self.k = k_sigma
        self.min_steps = min_steps
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        slow = False
        if len(hist) >= self.min_steps:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            slow = dt > mu + self.k * sd and dt > 1.5 * mu
            if slow:
                self.flagged.append((step, dt))
        self.times.append(dt)
        return slow


def _flatten(tree):
    """Leaves in the reference's order (dict keys sorted) and a function
    that rebuilds the tree from a list of leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        leaves = [l for p in parts for l in p[0]]
        sizes = [len(p[0]) for p in parts]

        def rebuild(ls):
            out, i = {}, 0
            for k, (_, rb), n in zip(keys, parts, sizes):
                out[k] = rb(ls[i:i + n])
                i += n
            return out
        return leaves, rebuild
    return [tree], lambda ls: ls[0]


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``: the gradient of ``loss`` with respect to every leaf of
    ``params`` (zero where the loss does not reach one), the tree's
    structure kept. The leaves are taken as detached views, so ``params``
    itself records nothing."""
    leaves, rebuild = _flatten(params)
    xs = [l.detach().requires_grad_(True) for l in leaves]
    loss, metrics = loss_fn(rebuild(xs), batch)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(xs, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (loss.detach(), metrics), rebuild(grads)


def make_train_step(loss_fn: Callable, adam_cfg: AdamConfig):
    """``(params, opt, batch) → (params, opt, metrics)`` around any
    ``loss_fn(params, batch) -> (loss, metrics)``."""

    def step(params, opt: AdamState, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt, opt_m = adam_update(adam_cfg, grads, opt, params)
        return params, opt, {"loss": loss, **metrics, **opt_m}

    return step


def _device(tree):
    leaves, _ = _flatten(tree)
    return leaves[0].device


def _meta(tree):
    """``tree`` with each leaf an empty tensor of its shape and dtype on
    the ``meta`` device (a restore template that allocates nothing)."""
    leaves, rebuild = _flatten(tree)
    return rebuild([torch.empty_like(l, device="meta") for l in leaves])


def train(params, loss_fn: Callable, data_at: Callable[[int], Any],
          cfg: TrainConfig, adam_cfg: AdamConfig,
          step_factory: Callable | None = None,
          log: Callable[[str], None] = print) -> dict:
    """Run (or resume) training. Returns the final state and history:
    ``params``, ``opt``, ``history`` (the loss of each step run),
    ``stragglers``, ``last_step`` and ``times`` (each step's seconds on
    the host clock, ending in the loss's read-back, which waits for the
    device).

    ``data_at(step)`` must be a pure function of the step index.
    ``step_factory`` overrides ``make_train_step`` (e.g. the launcher's
    in-place step). On a resume ``params`` gives only the structure,
    shapes, dtypes and device: the checkpoint's tensors replace it, and
    this function drops its own reference to it before they are read.
    """
    train_step = (step_factory or make_train_step)(loss_fn, adam_cfg)

    start = 0
    mgr = CheckpointManager(cfg.ckpt_dir, cfg.keep) if cfg.ckpt_dir else None
    if mgr and mgr.latest_step() is not None:
        dev, like = _device(params), _meta(params)
        del params
        (params, opt), meta = mgr.restore((like, adam_init(like)),
                                          device=dev)
        start = meta["step"] + 1
        log(f"[train] resumed from step {meta['step']}")
    else:
        opt = adam_init(params)

    monitor = StragglerMonitor()
    history = []
    preempted = {"flag": False}

    def _sigterm(signum, frame):
        preempted["flag"] = True

    old = signal.signal(signal.SIGTERM, _sigterm)
    failed_once = {"done": False}
    step = start - 1
    try:
        for step in range(start, cfg.steps):
            t0 = time.perf_counter()
            batch = data_at(step)
            params, opt, metrics = train_step(params, opt, batch)
            if cfg.fail_at_step is not None and step == cfg.fail_at_step \
                    and not failed_once["done"]:
                failed_once["done"] = True
                raise RuntimeError(f"injected failure at step {step}")
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            slow = monitor.record(step, dt)
            if slow:
                log(f"[train] straggler flagged at step {step}: {dt*1e3:.0f} ms")
            if step % cfg.log_every == 0:
                log(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            history.append(loss)
            if mgr and (step % cfg.ckpt_every == 0 or step == cfg.steps - 1
                        or preempted["flag"]):
                mgr.save(step, (params, opt), {"loss": loss})
            if preempted["flag"]:
                log(f"[train] preempted at step {step}; checkpointed and exiting")
                break
    finally:
        signal.signal(signal.SIGTERM, old)
    return {"params": params, "opt": opt, "history": history,
            "stragglers": monitor.flagged,
            "last_step": step if cfg.steps else -1, "times": monitor.times}
