"""Negative fixture: device-clean hot code plus justified allowlisted syncs.

Linting this file with the all-hot spec must report ZERO findings.
"""
import numpy as np
import torch

_TABLE = torch.zeros((128,))            # module-scope constant: fine


def decode_clean(tok, pos):
    x = torch.ones((4,)) + _TABLE[:4]
    y = torch.where(pos > 0, x, tok)    # device-side select: fine
    return y.sum()


def flush_boundary(tok):
    done = torch.cumsum(tok, 0)
    # repro: allow(host-sync) flush boundary materializes finished tokens
    arr = np.asarray(done)
    return arr.tolist()


def stepwise_oracle(tok, pos):  # repro: allow(host-sync) oracle syncs per step by design
    x = torch.ones((2,)) + tok
    return int(x.sum()), float(x.max())


def step(params, caches):
    return params, caches


step_fn = step                          # updated in place: fine
