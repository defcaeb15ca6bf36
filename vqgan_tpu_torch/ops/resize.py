"""Image resizing ops (counterpart of ``vqgan_tpu/ops/resize.py``).

``area_downsample`` and ``resize_area`` take and return NHWC (B, H, W, C),
the JAX package's layout; ``nearest_upsample_2x`` and
``nearest_upsample_2x_3d`` work inside the models on (B, C, H, W) and
(B, C, T, H, W).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool downsample of NHWC by an integer factor (== torch's
    ``interpolate(mode="area")`` for that factor)."""
    b, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {factor}")
    return F.avg_pool2d(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def resize_area(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Area-resize NHWC to ``size``: x itself when the size matches, the
    average pool for an integer factor shared by H and W."""
    b, h, w, c = x.shape
    th, tw = size
    if h == th and w == tw:
        return x
    if h % th == 0 and w % tw == 0 and h // th == w // tw:
        return area_downsample(x, h // th)
    raise NotImplementedError(
        f"resize_area {(h, w)} -> {size}: the non-integer (linear) resize is "
        "not ported yet (ROADMAP.md, Queue 1: ops)"
    )


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of (B, C, H, W); keeps channels_last."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def nearest_upsample_2x_3d(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of (B, C, T, H, W) in T, H and W (JAX
    ``ops/resize.py:44``); returns channels_last_3d."""
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    return y.contiguous(memory_format=torch.channels_last_3d)
