"""Fault-tolerant LM training on the port
(``examples/train_restartable_lm.py``): joint QAT over the merged profile
family with checkpoint/restart. Kill it mid-run (Ctrl-C or SIGTERM) and
re-launch — it resumes bit-exactly from the last committed checkpoint.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_restartable_lm \
          --steps 60 --ckpt-dir /tmp/aqe_ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "aqe_ckpt"))
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def launcher_argv(args: argparse.Namespace) -> list[str]:
    """The launcher's arguments, as the reference example builds them."""
    argv = ["--arch", args.arch, "--steps", str(args.steps),
            "--ckpt-dir", args.ckpt_dir]
    if args.grad_compression:
        argv.append("--grad-compression")
    return argv


def main(argv=None) -> dict:
    # thin veneer over the launcher so the example stays a single entry point
    args = parse_args(argv)
    extra = [] if args.device is None else ["--device", args.device]
    return train.main(launcher_argv(args) + extra)


if __name__ == "__main__":
    main()
