"""VGG16 feature extractor for LPIPS and the patch discriminator
(counterpart of ``vqgan_tpu/losses/vgg.py``).

torchvision's VGG16 ``.features`` cut at the reference's 5 taps (utils.py:92-131):
relu1_2, relu2_2, relu3_3, relu4_3, relu5_3, i.e. feature indices [0:4],
[4:9], [9:16], [16:23], [23:30], where each slice after the first starts with
the preceding maxpool. Each slice is an ``nn.Sequential`` that keeps
torchvision's indices as module names, so the state-dict keys are the
reference's: ``slice1.0.weight`` ... ``slice5.28.bias``.

Activations are (B, C, H, W) in ``torch.channels_last``; params fp32, each
conv computing in the module's ``dtype`` (``models/blocks.py::Conv2d``).

Over an image's H rows split in blocks over a ``context`` group
(``run_layers``) each 3×3 conv takes a halo row of each neighbour and the
2×2 max-pools are local, which holds where every rank's block is a whole
number of ``VGG_STRIDE`` rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from vqgan_tpu_torch.models.blocks import Conv2d

# out channels per conv, "M" = maxpool 2x2/2 (torchvision vgg16 features)
VGG16_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
                "M", 512, 512, 512)
TAP_CHANNELS = (64, 128, 256, 512, 512)  # reference utils.py:13
# torchvision features indices of the 13 convs, in order
TORCHVISION_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
# the slices end after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
SLICE_BOUNDS = (0, 4, 9, 16, 23, 30)
# the rows of the input that one row of the last tap stands for: the four
# 2x2 pools (and the patch discriminator's heads' patch)
VGG_STRIDE = 16


def run_layers(seq: nn.Module, x: torch.Tensor, context) -> torch.Tensor:
    """``seq``'s layers (nested ``nn.Sequential``s walked in order) on x,
    each ``Conv2d`` over this rank's H block of ``context``; ``seq(x)``
    itself without one (the whole image)."""
    if context is None:
        return seq(x)
    for m in seq:
        if isinstance(m, nn.Sequential):
            x = run_layers(m, x, context)
        elif isinstance(m, Conv2d):
            x = m.conv(x, context)
        else:
            x = m(x)
    return x


def slice_of(idx: int) -> int:
    """The tap slice (1-5) that holds torchvision features index ``idx``."""
    return 1 + sum(idx >= lo for lo in SLICE_BOUNDS[1:-1])


def vgg16_slices(dtype: torch.dtype = torch.float32) -> list[nn.Sequential]:
    """The five tap slices of VGG16 features, with torchvision's indices as
    module names. Params are allocated, not initialized."""
    layers: list[nn.Module] = []
    cin = 3
    for item in VGG16_LAYOUT:
        if item == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [Conv2d(cin, item, 3, padding=1, dtype=dtype), nn.ReLU()]
            cin = item
    slices = []
    for lo, hi in zip(SLICE_BOUNDS[:-1], SLICE_BOUNDS[1:]):
        seq = nn.Sequential()
        for idx in range(lo, hi):
            seq.add_module(str(idx), layers[idx])
        slices.append(seq)
    return slices


@torch.no_grad()
def init_vgg_(module: nn.Module, generator: torch.Generator) -> None:
    """He-normal conv kernels and zero biases, the JAX package's VGG init,
    drawn from ``generator`` in module order."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.weight.normal_(0.0, math.sqrt(2.0 / m.weight[0].numel()),
                             generator=generator)
            m.bias.zero_()


class ScalingLayer(nn.Module):
    """Fixed shift and scale mapping [-1, 1] images to VGG input statistics
    (reference utils.py:60-71). Non-persistent buffers: not in the state
    dict, as in the reference's checkpoints."""

    def __init__(self):
        super().__init__()
        self.register_buffer(
            "shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
            persistent=False)
        self.register_buffer(
            "scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.shift.to(x.dtype)) / self.scale.to(x.dtype)


class VGG16Features(nn.Module):
    """(B, 3, H, W) channels_last → the 5 relu taps, in ``dtype``; with
    ``context`` x is this rank's block of H rows (``run_layers``) and so is
    each tap."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        for n, seq in enumerate(vgg16_slices(dtype), start=1):
            self.add_module(f"slice{n}", seq)

    def forward(self, x: torch.Tensor, context=None) -> tuple[torch.Tensor, ...]:
        taps = []
        for n in range(1, 6):
            x = run_layers(getattr(self, f"slice{n}"), x, context)
            taps.append(x)
        return tuple(taps)
