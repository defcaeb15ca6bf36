"""Image resizing ops (counterpart of ``vqgan_tpu/ops/resize.py``).

``area_downsample`` and ``resize_area`` take and return NHWC (B, H, W, C),
the JAX package's layout. ``resize_area`` between sizes that are not one
integer factor apart is ``jax.image.resize(..., method="linear")`` with its
default ``antialias=True``: each resized axis is a product with a weight
matrix built as ``jax/_src/image/scale.py::compute_weight_mat`` builds it
(``linear_weight_matrix``); ``nearest_upsample_2x`` and
``nearest_upsample_2x_3d`` work inside the models on (B, C, H, W) and
(B, C, T, H, W).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Average-pool downsample of NHWC by an integer factor (== torch's
    ``interpolate(mode="area")`` for that factor)."""
    b, h, w, c = x.shape
    if h % factor or w % factor:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {factor}")
    return F.avg_pool2d(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def linear_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fp32 weights of the antialiased linear resize of
    one axis (``compute_weight_mat`` with the triangle kernel, scale
    out/in, no translation): when downsampling the triangle widens by
    in/out; each output's weights are renormalized to sum to 1 (0 where the
    sum is below 1000 fp32 epsilons), and a sample outside the input takes
    none."""
    inv_scale = np.float32(1.0) / np.float32(out_size / in_size)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale
                - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def linear_resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NHWC ``x`` resized to ``size`` by the antialiased linear filter
    (``jax.image.resize(x, (B, *size, C), "linear")``): H, then W, each a
    product with its weight matrix in x's dtype; an axis whose size does not
    change is left alone."""
    for axis, n in ((1, size[0]), (2, size[1])):
        m = x.shape[axis]
        if m == n:
            continue
        w = torch.from_numpy(linear_weight_matrix(m, n)).to(x.device, x.dtype)
        x = torch.tensordot(x.movedim(axis, -1), w, dims=1).movedim(-1, axis)
    return x


def resize_area(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Area-resize NHWC to ``size``: x itself when the size matches, the
    average pool for an integer factor shared by H and W, else the
    antialiased linear resize (``linear_resize``), as the JAX package's
    ``resize_area`` falls back to ``jax.image.resize``."""
    b, h, w, c = x.shape
    th, tw = size
    if h == th and w == tw:
        return x
    if h % th == 0 and w % tw == 0 and h // th == w // tw:
        return area_downsample(x, h // th)
    return linear_resize(x, size).contiguous()


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of (B, C, H, W); keeps channels_last."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def nearest_upsample_2x_3d(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample of (B, C, T, H, W) in T, H and W (JAX
    ``ops/resize.py:44``); returns channels_last_3d."""
    y = F.interpolate(x, scale_factor=2, mode="nearest")
    return y.contiguous(memory_format=torch.channels_last_3d)
