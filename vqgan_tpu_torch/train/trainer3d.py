"""The 3D video VAE's training data helpers (counterpart of
``vqgan_tpu/train/trainer3d.py``). The ``Trainer3D`` loop, its checkpoints
and eval are not ported yet (ROADMAP.md, Queue 1: the training loop)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_video_batches(batch: int, frames: int, size: int,
                            seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic moving-gradient clips (B, T, H, W, 3) in [-1, 1], fp32:
    the JAX package's generator (``trainer3d.py:27-45``), draw for draw."""
    step = 0
    while True:
        rng = np.random.default_rng(seed * 7919 + step)
        t = np.arange(frames, dtype=np.float32)[None, :, None, None, None]
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        clips = []
        for _ in range(batch):
            vx, vy, ph = rng.uniform(-1, 1, 3).astype(np.float32)
            base = np.sin(
                2 * np.pi * (xx[None] * 2 + yy[None] * 3 + ph)
                + 0.3 * t[0, :, :, 0] * vx
            )
            clip = np.stack([base * c for c in rng.uniform(0.3, 1.0, 3)], -1)
            clips.append(np.clip(clip, -1, 1))
        yield np.stack(clips).astype(np.float32)
        step += 1
