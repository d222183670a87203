"""PyTorch/CUDA port of ``repro``: the adaptive-inference serving stack on
one NVIDIA H100.

The layout mirrors ``src/repro/`` path for path, so each module names its
reference. Entry points run on the GPU unless the caller passes
``device="cpu"`` (:mod:`repro_torch.runtime`); every TPU kernel on the
ported path is a hand-written Hopper kernel under :mod:`repro_torch.kernels`
with a plain-PyTorch version beside it.
"""
