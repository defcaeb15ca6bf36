"""VGG16-backed multi-scale patch discriminator (counterpart of
``vqgan_tpu/losses/discriminator.py::PatchDiscriminator``; reference
utils.py:143-203).

ScalingLayer → trainable VGG16 backbone → 5 binary-classifier conv heads, one
per feature tap, whose flattened patch logits are summed: every head gives
logits over the same patch grid (16×16 at 256²), so the sum is a per-patch
multi-scale vote. Each head's final conv starts with zero weights; biases
keep torch's default init (utils.py:161-185).

Head specs (the reference's):
  1: 64→32 (k4 s4) → ReLU → 32→1 (k4 s4)
  2: 128→64 (k4 s4) → ReLU → 64→1 (k2 s2)
  3: 256→128 (k2 s2) → ReLU → 128→1 (k2 s2)
  4: 512→1 (k2 s2)
  5: 512→1 (k1 s1)

State-dict keys are the reference's: the backbone under
``slice{n}.0.{idx}.*`` (each VGG slice wrapped in one more Sequential) and
the heads as ``binary_classifier{k}.{0,2}.*``.

Over an image's H rows split in blocks over a ``context`` group: where each
block is a whole number of ``VGG_STRIDE`` rows (a whole number of patches)
the backbone runs on the blocks (halos in its convs) and the heads, whose
kernel is their stride, are local, so a rank's logits are its patch rows;
otherwise the images are gathered and D runs on them whole on every rank
(``parallel/context.py::gather_blocks``). Every mean over the patches is then
the mean over the ranks' equal shares (the train step's).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqgan_tpu_torch.losses.vgg import (
    VGG_STRIDE,
    ScalingLayer,
    init_vgg_,
    run_layers,
    vgg16_slices,
)
from vqgan_tpu_torch.models.blocks import Conv2d, nchw
from vqgan_tpu_torch.parallel.context import gather_blocks

# (in, out, kernel = stride) of each head's convs, in Sequential order
_HEADS = (
    ((64, 32, 4), (32, 1, 4)),
    ((128, 64, 4), (64, 1, 2)),
    ((256, 128, 2), (128, 1, 2)),
    ((512, 1, 2),),
    ((512, 1, 1),),
)


class PatchDiscriminator(nn.Module):
    """(B, H, W, 3) in [-1, 1] → (B, P) fp32 patch logits. The convs compute
    in ``dtype`` on fp32 params."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scaling_layer = ScalingLayer()
        for n, seq in enumerate(vgg16_slices(dtype), start=1):
            self.add_module(f"slice{n}", nn.Sequential(seq))
        for k, convs in enumerate(_HEADS, start=1):
            layers: list[nn.Module] = []
            for i, (cin, cout, ks) in enumerate(convs):
                if i:
                    layers.append(nn.ReLU())
                layers.append(Conv2d(cin, cout, ks, stride=ks, dtype=dtype))
            self.add_module(f"binary_classifier{k}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        """``context``: the group whose ranks hold x's blocks of H rows (the
        module docstring); the logits are then this rank's patch rows, or
        every patch where x was gathered."""
        if context is not None and x.shape[1] % VGG_STRIDE:
            x, context = gather_blocks(x, 1, context), None
        h = self.scaling_layer(nchw(x))
        b = h.shape[0]
        logits = None
        for k in range(1, 6):
            h = run_layers(getattr(self, f"slice{k}"), h, context)
            head = getattr(self, f"binary_classifier{k}")(h).reshape(b, -1)
            logits = head if logits is None else logits + head
        return logits.float()


# channels of the five VGG16 taps
_TAP_CHANNELS = (64, 128, 256, 512, 512)


class TemporalMix(nn.Module):
    """A depthwise temporal conv of each channel over the frames, kernel
    (kt, 1, 1), SAME padding in T, no bias (JAX ``TubeletDiscriminator._tmix``):
    flax's ``nn.Conv(C, (kt, 1, 1), padding="SAME", feature_group_count=C)``,
    whose (kt, 1, 1, 1, C) kernel is the (C, 1, kt, 1, 1) ``weight`` here.
    SAME pads (kt − 1)//2 frames before and the rest after, as XLA does."""

    def __init__(self, channels: int, kt: int, dtype: torch.dtype):
        super().__init__()
        self.kt = kt
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, 1, kt, 1, 1))

    def forward(self, f: torch.Tensor, b: int, t: int) -> torch.Tensor:
        """(B·T, C, h, w) channels_last → the same, mixed over T."""
        bt, c, h, w = f.shape
        # channels_last (B·T, C, h, w) is physically (B, T, h, w, C): a view
        f5 = f.permute(0, 2, 3, 1).reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3)
        lo = (self.kt - 1) // 2
        f5 = F.pad(f5.to(self.dtype), (0, 0, 0, 0, lo, self.kt - 1 - lo))
        y = F.conv3d(f5, self.weight.to(self.dtype), groups=c)
        return y.permute(0, 2, 3, 4, 1).reshape(bt, h, w, c).permute(0, 3, 1, 2)


class TubeletDiscriminator(PatchDiscriminator):
    """The spatio-temporal patch discriminator of the video GAN (counterpart
    of ``vqgan_tpu/losses/discriminator.py::TubeletDiscriminator``): the
    ``PatchDiscriminator``'s VGG16 runs on every frame as one (B·T) batch,
    each of its five taps passes a ``TemporalMix`` (``tmix1``..``tmix5``) on
    its way to its head (the next VGG slice takes the unmixed tap), and the
    heads' patch logits are summed as in 2D. ``frames`` is the T it is
    called with, which sets the temporal kernel min(3, T) as flax does at
    init. (B, T, H, W, 3) in [-1, 1] → (B, T·P) fp32 logits. State-dict
    keys: the ``PatchDiscriminator``'s and ``tmix{k}.weight``."""

    def __init__(self, frames: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        kt = min(3, frames)
        for k, c in enumerate(_TAP_CHANNELS, start=1):
            self.add_module(f"tmix{k}", TemporalMix(c, kt, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        h = self.scaling_layer(nchw(x.reshape(b * t, *x.shape[2:])))
        logits = None
        for k in range(1, 6):
            h = getattr(self, f"slice{k}")(h)
            f = getattr(self, f"tmix{k}")(h, b, t)
            head = getattr(self, f"binary_classifier{k}")(f).reshape(b, -1)
            logits = head if logits is None else logits + head
        return logits.float()


@torch.no_grad()
def init_discriminator_(disc: PatchDiscriminator, generator: torch.Generator) -> None:
    """The JAX package's init, drawn from ``generator``: He-normal backbone
    with zero biases; head convs torch's default U(±1/√fan_in) for weights
    and biases, except each head's final conv, whose weights are zero; a
    ``TubeletDiscriminator``'s temporal mixers the identity, only the center
    tap kt//2 set to 1 (JAX ``_identity_temporal_init``)."""
    for n in range(1, 6):
        init_vgg_(getattr(disc, f"slice{n}"), generator)
    for k in range(1, 6):
        convs = [m for m in getattr(disc, f"binary_classifier{k}")
                 if isinstance(m, Conv2d)]
        for i, m in enumerate(convs):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            if i == len(convs) - 1:
                m.weight.zero_()
            else:
                m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    for m in disc.modules():
        if isinstance(m, TemporalMix):
            m.weight.zero_()
            m.weight[:, :, m.kt // 2] = 1.0
