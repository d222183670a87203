"""Seeded host-sync violations: every construct the lint must catch."""
import numpy as np
import torch


def decode_loop(tok, pos):
    x = torch.ones((4,))
    y = float(x.sum())                  # host-sync: float() on device value
    arr = np.asarray(x * 2)             # host-sync: np.asarray of a tensor
    z = x.sum().item()                  # host-sync: .item()
    torch.cuda.synchronize()            # host-sync: explicit barrier
    h = x.cpu()                         # host-sync: .cpu()
    n = x.numpy()                       # host-sync: .numpy()
    l = x.tolist()                      # host-sync: .tolist() of a tensor
    if x.sum() > 0:                     # host-sync: branch on a tensor
        y = 0.0
    return y, arr, z, h, n, l
