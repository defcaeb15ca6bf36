"""LPIPS perceptual distance (counterpart of ``vqgan_tpu/losses/lpips.py``;
reference utils.py:8-57).

ScalingLayer → frozen VGG16 features at 5 taps → per-tap channelwise unit
normalization → squared difference → learned 1×1 head (bias-free) → spatial
mean → sum over taps. Every parameter is frozen.

The two images run as SEPARATE VGG passes, and the target's pass runs under
``torch.no_grad()``: the target and the frozen VGG are constants, so autograd
builds no backward for that branch (the JAX package measured a halved LPIPS
backward from the same split, ``vqgan_tpu/losses/lpips.py:14-25``).

State-dict keys are the reference's (``vgg.pth``): the VGG under
``net.slice{n}.{idx}.*`` and the heads as ``lin{k}.model.1.weight`` of shape
(1, C, 1, 1). Without real weights the heads start at 1/C (each tap a plain
normalized-feature MSE), as in the JAX package.

Over an image's H rows split in blocks over a ``context`` group, LPIPS gives
the whole images' distances on every rank of the group: where each block is
a whole number of ``VGG_STRIDE`` rows the towers run on the blocks (halos in
their convs, ``vgg.py``) and each tap's spatial sum is summed over the group
and divided by the whole tap's H·W; otherwise the images are gathered and
LPIPS runs on them whole on every rank (its backward keeps this rank's rows
of the summed gradients, ``parallel/context.py::gather_blocks``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vqgan_tpu_torch.losses.vgg import (
    TAP_CHANNELS,
    VGG_STRIDE,
    ScalingLayer,
    VGG16Features,
    init_vgg_,
)
from vqgan_tpu_torch.models.blocks import nchw
from vqgan_tpu_torch.parallel.context import all_sum, gather_blocks
from vqgan_tpu_torch.parallel.mesh import group_size


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """L2-normalize over the channel axis (reference utils.py:134-136)."""
    norm = x.square().sum(dim=1, keepdim=True).sqrt()
    return x / (norm + eps)


class LinHead(nn.Module):
    """The bias-free 1×1 conv to one channel, as a channel dot in fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1, channels, 1, 1), 1.0 / channels))

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return (d * self.weight).sum(dim=1)


class NetLinLayer(nn.Module):
    """``model.1.weight``: index 0 is the reference's dropout, which an LPIPS
    used as a loss runs in eval mode, i.e. the identity."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), LinHead(channels))

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        return self.model(d)


class LPIPS(nn.Module):
    """Call with (recon, target), each (B, H, W, 3) in [-1, 1]; returns the
    (B, 1) per-image distances. The VGG convs compute in ``dtype``. The VGG
    params are allocated, not initialized: load a state dict, or use
    ``init_lpips_``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        self.net = VGG16Features(dtype)
        for k, c in enumerate(TAP_CHANNELS):
            self.add_module(f"lin{k}", NetLinLayer(c))
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor, context=None) -> torch.Tensor:
        """``context``: the group whose ranks hold x's and y's blocks of H
        rows (the module docstring)."""
        n = group_size(context)
        if context is not None and x.shape[1] % VGG_STRIDE:
            x, y = gather_blocks(x, 1, context), gather_blocks(y, 1, context)
            context, n = None, 1
        taps_x = self.net(self.scaling_layer(nchw(x)), context)
        with torch.no_grad():
            taps_y = self.net(self.scaling_layer(nchw(y)), context)
        total = None
        for k, (tx, ty) in enumerate(zip(taps_x, taps_y)):
            diff = (_unit_normalize(tx.float()) - _unit_normalize(ty.float())).square()
            d = getattr(self, f"lin{k}")(diff)
            if context is None:
                val = d.mean(dim=(1, 2))  # spatial mean
            else:
                val = all_sum(d.sum(dim=(1, 2)), context) / (n * d.shape[1] * d.shape[2])
            total = val if total is None else total + val
        return total[:, None]


@torch.no_grad()
def init_lpips_(lpips: LPIPS, generator: torch.Generator) -> None:
    """The JAX package's init without real weights: the VGG's from
    ``init_vgg_``, drawn from ``generator``, and every head 1/C."""
    init_vgg_(lpips.net, generator)
    for k, c in enumerate(TAP_CHANNELS):
        getattr(lpips, f"lin{k}").model[1].weight.fill_(1.0 / c)
