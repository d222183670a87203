"""Synthetic MNIST-like digit dataset (deterministic, offline).

Copy of ``repro/data/digits.py`` (numpy only, so the port keeps its own).

MNIST itself is not available in this container (DESIGN §8.5); we render
seven-segment-style digit glyphs at 28×28 with randomized geometry
(shift/thickness/contrast) and additive noise. The task keeps the properties
the paper's Table 1 depends on: 10 classes, high float accuracy, and
accuracy that *degrades gracefully* under aggressive quantization.

Everything is generated with numpy from an integer seed — runs are bit-exact
reproducible across restarts (needed by the checkpoint/restart tests).
"""
from __future__ import annotations

import numpy as np

__all__ = ["SEGMENTS", "render_digit", "make_dataset", "batches"]

# classic 7-segment truth table: (top, tl, tr, mid, bl, br, bottom)
SEGMENTS = {
    0: (1, 1, 1, 0, 1, 1, 1),
    1: (0, 0, 1, 0, 0, 1, 0),
    2: (1, 0, 1, 1, 1, 0, 1),
    3: (1, 0, 1, 1, 0, 1, 1),
    4: (0, 1, 1, 1, 0, 1, 0),
    5: (1, 1, 0, 1, 0, 1, 1),
    6: (1, 1, 0, 1, 1, 1, 1),
    7: (1, 0, 1, 0, 0, 1, 0),
    8: (1, 1, 1, 1, 1, 1, 1),
    9: (1, 1, 1, 1, 0, 1, 1),
}


_DIFFICULTY = {
    # (thickness lo/hi, jitter, noise σ, contrast lo/range)
    "easy": (2, 4, 3, 0.25, 0.6, 0.4),
    "hard": (2, 4, 4, 0.35, 0.50, 0.40),  # Table-1 regime: quantization-sensitive
}


def render_digit(digit: int, rng: np.random.Generator, size: int = 28,
                 difficulty: str = "easy") -> np.ndarray:
    """One noisy glyph image in [0, 1], shape [size, size]."""
    th_lo, th_hi, jit, sigma, c_lo, c_rng = _DIFFICULTY[difficulty]
    img = np.zeros((size, size), np.float32)
    th = rng.integers(th_lo, th_hi)          # stroke thickness
    dx = int(rng.integers(-jit, jit + 1))    # jitter
    dy = int(rng.integers(-jit, jit + 1))
    x0, x1 = 8 + dx, 20 + dx                 # glyph box columns
    y0, ym, y1 = 4 + dy, 14 + dy, 24 + dy    # rows: top / middle / bottom

    def hseg(y, on):
        if on:
            img[max(y, 0):min(y + th, size), max(x0, 0):min(x1, size)] = 1.0

    def vseg(ya, yb, x, on):
        if on:
            img[max(ya, 0):min(yb, size), max(x, 0):min(x + th, size)] = 1.0

    top, tl, tr, mid, bl, br, bot = SEGMENTS[digit]
    hseg(y0, top)
    hseg(ym, mid)
    hseg(y1 - th + 1, bot)
    vseg(y0, ym, x0, tl)
    vseg(y0, ym, x1 - th, tr)
    vseg(ym, y1, x0, bl)
    vseg(ym, y1, x1 - th, br)

    contrast = c_lo + c_rng * rng.random()
    img = img * contrast + rng.normal(0.0, sigma, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_dataset(n: int, seed: int, size: int = 28, difficulty: str = "easy"):
    """Returns (images [n, size, size, 1] f32, labels [n] i32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.stack([render_digit(int(l), rng, size, difficulty)
                     for l in labels])
    return imgs[..., None].astype(np.float32), labels


def batches(images: np.ndarray, labels: np.ndarray, batch_size: int, seed: int):
    """Infinite deterministic shuffled batch iterator."""
    n = len(labels)
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield images[sel], labels[sel]
