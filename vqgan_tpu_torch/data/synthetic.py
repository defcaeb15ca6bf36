"""Deterministic synthetic image batches for tests and benchmarking (a copy
of ``vqgan_tpu/data/synthetic.py``, draw for draw).

Structured (not pure-noise) images: random smooth gradients + rectangles so
perceptual/GAN losses see edges and flat regions. Deterministic per (seed,
step) so runs are reproducible.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def _make_image(rng: np.random.Generator, size: int) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        a, b, ph = rng.uniform(-1, 1, 3)
        img[..., c] = a * xx + b * yy + 0.3 * np.sin(2 * np.pi * (2 * xx + 3 * yy + ph))
    for _ in range(rng.integers(2, 6)):
        h0, w0 = rng.integers(0, size - 8, 2)
        h1 = h0 + rng.integers(4, max(5, size // 2))
        w1 = w0 + rng.integers(4, max(5, size // 2))
        img[h0:h1, w0:w1] += rng.uniform(-1, 1, (1, 1, 3)).astype(np.float32)
    return np.clip(img, -1.0, 1.0)


def synthetic_dataloader(batch_size: int, image_size: int = 512,
                         seed: int = 0) -> Iterator[np.ndarray]:
    """(B, S, S, 3) float32 batches in [-1, 1]; batch ``step`` is drawn from
    ``default_rng(seed * 1_000_003 + step)``."""
    step = 0
    while True:
        rng = np.random.default_rng(seed * 1_000_003 + step)
        yield np.stack([_make_image(rng, image_size) for _ in range(batch_size)])
        step += 1
