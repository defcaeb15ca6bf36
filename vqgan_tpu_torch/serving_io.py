"""Host arrays in, device tensors through, host arrays out: the input and
output conventions that ``inference.py``'s pipelines and ``export.py``'s
artifacts share. Imports no model code, so a process that serves an
exported artifact needs none."""

from __future__ import annotations

import numpy as np
import torch


def to_device(a, device: torch.device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))  # a writable host copy
    return a.to(device)


def model_input(a, device: torch.device, one_ndim: int) -> torch.Tensor:
    """uint8 [0, 255] → float [-1, 1] on the device; a single item (``one_ndim``
    dimensions) gains a batch dimension."""
    x = to_device(a, device)
    if x.dtype == torch.uint8:
        x = x.float() / 127.5 - 1.0
    if x.ndim == one_ndim:
        x = x[None]
    return x.float()


def unit_range(dec: torch.Tensor) -> torch.Tensor:
    """Decoder output in [-1, 1] → float32 in [0, 1], on its device."""
    return (dec.float() * 0.5 + 0.5).clamp(0.0, 1.0)
