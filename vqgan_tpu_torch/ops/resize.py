"""Image resizing ops (counterpart of ``vqgan_tpu/ops/resize.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of (B, C, H, W); keeps channels_last."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
