"""Multi-channel 2D wavelet decomposition, the encoder's front end in wavelet
mode (counterpart of ``vqgan_tpu/ops/wavelet.py``; reference
utils.py:206-247).

The reference's analysis bank: 6-tap low- and high-pass filters whose outer
products form four separable 2D filters, applied to each input channel with
stride 2 after a 2-pixel zero pad. (B, H, W, C) → (B, H/2, W/2, 4C), channel
``c*4 + f``. Here one grouped ``F.conv2d`` (``groups=C``, cuDNN on the
card) computes it in fp32; the result takes x's dtype, as in the JAX
package. Both sides compute a cross-correlation, so the filters are not
flipped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# reference utils.py:206-209
DEC_LO = np.array([-0.1768, 0.3536, 1.0607, 0.3536, -0.1768, 0.0000], np.float32)
DEC_HI = np.array([0.0000, -0.0000, 0.3536, -0.7071, 0.3536, -0.0000], np.float32)


@functools.lru_cache(maxsize=None)
def _filters() -> np.ndarray:
    """(4, 6, 6): filter f over (rows, cols), in the JAX package's
    orientation (``wavelet.py:28-41``): f0 = lo⊗lo, f1 = hi(rows)⊗lo(cols),
    f2 = lo⊗hi, f3 = hi⊗hi."""
    lo, hi = DEC_LO, DEC_HI
    return np.stack([np.outer(lo, lo), np.outer(hi, lo), np.outer(lo, hi), np.outer(hi, hi)])


def wavelet_weight(channels: int, device=None) -> torch.Tensor:
    """The grouped conv's OIHW weight (4C, 1, 6, 6): ``w[c*4 + f, 0]`` is
    filter f."""
    filt = torch.from_numpy(_filters()).to(device)
    return filt.repeat(channels, 1, 1).unsqueeze(1)


def wavelet_transform_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, 4C, H/2, W/2) in x's dtype, computed in fp32."""
    c = x.shape[1]
    xf = F.pad(x.float(), (2, 2, 2, 2))
    out = F.conv2d(xf, wavelet_weight(c, x.device), stride=2, groups=c)
    return out.to(x.dtype)


def wavelet_transform_multi_channel(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B, H/2, W/2, 4C), channel order c*4 + f (the JAX
    package's signature and layout)."""
    return wavelet_transform_nchw(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
