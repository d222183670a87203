"""Seeded eager-hygiene violations: tensor branch, closure, constant."""
import torch
import torch.nn.functional as F


def step(params, caches):               # carry threaded (updated in place)
    return params, caches


step_fn = step                          # no donate in eager: nothing fires


def branchy(flag, x):
    if F.relu(x).sum() > 0:             # host-sync: bool() of a tensor
        return x + 1
    return x


branchy_fn = branchy


def make_closure():
    def inner(x):
        return x + scale                # late-closure: scale assigned below

    scale = 3.0
    return inner


def build_table(x):
    table = torch.tensor([0.0] * 64)    # device-constant: 64-element literal
    return x + table
