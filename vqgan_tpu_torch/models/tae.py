"""3D video VAE, "TVAE" (counterpart of ``vqgan_tpu/models/tae.py``).

Conv3d everywhere; stride-2 downsample over (T, H, W) after an asymmetric
(0, 1) pad of all three; nearest 2× upsample in all three; attention with a
fixed 8 heads of C/8; the encoder emits 2·z_channels for the Gaussian; torch's
default init, biases not zeroed (reference tae.py:57-90).

Every stride-1 3×3×3 SAME conv goes through ``Conv3d``, which picks by
``TVAEConfig.conv3d_impl`` (the config says how) between kernel #6
(``ops/conv3d_cuda.py``) and ``F.conv3d``. Module names give the reference
state-dict keys (``encoder.down.0.block.1.conv1.weight``,
``encoder.mid.attn_1.qkv.weight``, ``decoder.up.2.upsample.conv.bias``, ...),
the same the JAX package's converter gives for its param tree.

``TVAE.encode``/``decode``/``deterministic_latent`` keep the JAX package's
layout: clips (B, T, H, W, C) and latents (B, t, h, w, z). Inside, tensors are
(B, C, T, H, W) in ``torch.channels_last_3d`` memory format, which is
physically NDHWC: cuDNN's 3D layout and the (B, T·H·W, C) view the GroupNorm
and Conv3d kernels read. The model computes in ``compute_dtype``; params are
fp32 and GroupNorm computes in fp32.

With a ``context`` process group (``TVAE(cfg, context=group)``; JAX
``TVAE(mesh, ring_axis)``) each rank holds a contiguous block of the clip's
T frames and the model computes the whole clip's function on it
(``parallel/context.py``): every stride-1 3×3×3 conv runs on its block with
one halo frame of each neighbour (``halo``), VALID in T; the downsample's
(0, 1) T pad is a right halo of one frame, zeros on the last rank; the
upsample doubles its block and its conv takes halos; every GroupNorm takes
the two-pass form across the group (``ContextGroupNorm``); the mid-block
attention runs as exact ring attention (``ops/ring_attention.py``, kernel
#3 once a ring step). The parameter tree is the same with or without it.

With ``remat`` (JAX ``tae.py:645, 669, 702, 720, 762-763``) each level is a
rematerialized region with its ResnetBlock3Ds nested inside it, and the mid
blocks are regions of their own (``blocks.remat_call``; kernel #6's launches
are not aten ops, so the "conv" policy keeps only the ``F.conv3d`` outputs,
and the backward launches #6 again for the rest).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vqgan_tpu_torch.config import CONV3D_IMPLS, DTYPES, TVAEConfig
from vqgan_tpu_torch.models.ae import DiagonalGaussian
from vqgan_tpu_torch.models.blocks import FP32GroupNorm, remat_call, remat_policy_of
from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.ops.attention import dense_attention, memory_efficient_attention
from vqgan_tpu_torch.ops.conv3d_cuda import conv3d_ttap
from vqgan_tpu_torch.ops.resize import nearest_upsample_2x_3d
from vqgan_tpu_torch.ops.ring_attention import ring_attention
from vqgan_tpu_torch.parallel.context import halo
from vqgan_tpu_torch.parallel.mesh import group_size

NUM_HEADS = 8  # reference tae.py:17-18, for every width


def ncdhw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) → (B, C, T, H, W) channels_last_3d (a view when x is a
    contiguous NDHWC tensor)."""
    return x.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Conv3d(nn.Module):
    """A Conv3d with fp32 OIDHW params that computes in ``dtype``.

    A stride-1 3×3×3 conv with padding 1 whose ``impl`` picks the kernel
    (``TVAEConfig`` says which values do) runs ``conv3d_ttap``: kernel #6 on
    a CUDA tensor, its plain version on a CPU tensor; the bias is added after
    the kernel's cast, in the output dtype, as ``Conv3DTapPallas`` does. Every
    other conv runs ``F.conv3d``. ``init_std``: normal init with this std
    instead of torch's default; ``bias=False``: no bias parameter.

    With a ``context`` group (set by ``TVAE``) a 3×3×3 stride-1 conv runs on
    its T block with a halo frame of each neighbour: the kernel computes
    SAME on the extended block and its two end frames are dropped (SAME on
    the extended block is VALID in T on the clip; the backward's dy is
    zero-padded to match), ``F.conv3d`` pads H and W only."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dtype: torch.dtype = torch.float32,
                 impl: str = "direct", init_std: float | None = None, bias: bool = True):
        super().__init__()
        if impl not in CONV3D_IMPLS:
            raise ValueError(f"unknown conv3d_impl {impl!r}")
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.impl = impl
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *(kernel_size,) * 3))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.fused_tap = (kernel_size, stride, padding) == (3, 1, 1)
        self.context = None

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """Whether this call goes through ``conv3d_ttap``."""
        if not self.fused_tap:
            return False
        if self.impl == "auto":
            return x.is_cuda
        if self.impl == "mixed":  # the JAX package's per-width split
            return min(self.weight.shape[:2]) >= 128
        return self.impl == "pallas"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.context is not None and self.fused_tap:
            return self._forward_halo(x.to(dt))
        if self.uses_kernel(x):
            out = conv3d_ttap(x.to(dt), self.weight.to(dt))
            return out if self.bias is None else out + self.bias.to(dt).view(-1, 1, 1, 1)
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)
        return y.contiguous(memory_format=torch.channels_last_3d)

    def _forward_halo(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        xe = halo(x, 1, 1, self.context)
        bias = None if self.bias is None else self.bias.to(dt)
        if self.uses_kernel(x):
            out = conv3d_ttap(xe, self.weight.to(dt))[:, :, 1:-1]
            if bias is not None:
                out = out + bias.view(-1, 1, 1, 1)
        else:
            out = F.conv3d(xe, self.weight.to(dt), bias, 1, (0, 1, 1))
        return out.contiguous(memory_format=torch.channels_last_3d)


@torch.no_grad()
def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The reference TVAE init, drawn from ``generator`` in module order:
    torch's Conv3d default (weight and bias U(±1/√fan_in)) or a normal of
    ``init_std``; GroupNorm weight 1, bias 0; a VQ codebook the JAX
    package's init (``init_codebook_``)."""
    for m in module.modules():
        if isinstance(m, Conv3d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            if m.init_std is None:
                m.weight.uniform_(-bound, bound, generator=generator)
            else:
                m.weight.normal_(0.0, m.init_std, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, FP32GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, VectorQuantizer):
            m.init_codebook_(generator)


class ResnetBlock3D(nn.Module):
    """norm→swish→conv ×2 plus the (1×1×1 ``nin_shortcut``) residual. The
    GroupNorms are ``FP32GroupNorm`` on 5-D input; with ``fused_swish`` the
    swish runs in the GroupNorm's sweep, else ``F.silu`` follows in the
    activation dtype (JAX ``tae.py:392-441``; the 3D default is unfused)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype,
                 fused_swish: bool = False, conv3d_impl: str = "direct",
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.fused_swish = fused_swish
        self.remat_policy = remat_policy
        self.norm1 = FP32GroupNorm(in_channels, fused_swish=fused_swish)
        self.conv1 = Conv3d(in_channels, out_channels, 3, padding=1, dtype=dtype,
                            impl=conv3d_impl)
        self.norm2 = FP32GroupNorm(out_channels, fused_swish=fused_swish)
        self.conv2 = Conv3d(out_channels, out_channels, 3, padding=1, dtype=dtype,
                            impl=conv3d_impl)
        self.nin_shortcut = (Conv3d(in_channels, out_channels, 1, dtype=dtype)
                             if in_channels != out_channels else None)

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.fused_swish else F.silu(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat_call(self._forward, self.remat_policy, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self._act(self.norm1(x)))
        h = self.conv2(self._act(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock3D(nn.Module):
    """Self-attention over the flattened T·H·W tokens, 8 heads of C/8
    (reference tae.py:13-54; JAX ``tae.py:444-558``): GroupNorm without
    swish, a bias-free 1×1×1 qkv conv whose channels split into thirds (q, k,
    v) and each third into heads, attention with scale head_dim^-½, a
    bias-free 1×1×1 proj_out, residual add. ``attn_chunk`` as in the 2D
    ``AttnBlock``: above it the memory-efficient path (kernel #3 on the card,
    the chunked plain version on the CPU), and it must divide T·H·W. With a
    ``context`` group (set by ``TVAE``) the tokens are this rank's T block
    and the attention is ring attention over the group, whatever
    ``attn_chunk``."""

    def __init__(self, channels: int, dtype: torch.dtype, attn_chunk: int = 0,
                 attn_impl: str = "auto"):
        super().__init__()
        self.attn_chunk = attn_chunk
        self.attn_impl = attn_impl
        self.context = None
        self.norm = FP32GroupNorm(channels)
        self.qkv = Conv3d(channels, 3 * channels, 1, dtype=dtype, bias=False)
        self.proj_out = Conv3d(channels, channels, 1, dtype=dtype, bias=False,
                               init_std=0.2 / math.sqrt(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, h, w = x.shape
        n = t * h * w
        qkv = self.qkv(self.norm(x))
        # channels_last_3d qkv is physically (B, N, 3C): q, k, v are views
        q, k, v = _ndhwc(qkv).reshape(b, n, 3, NUM_HEADS, c // NUM_HEADS).unbind(2)
        if self.context is not None:
            out = ring_attention(q, k, v, self.context, self.attn_chunk)
        elif self.attn_chunk and n > self.attn_chunk:
            if n % self.attn_chunk:
                raise ValueError(
                    f"attn_chunk {self.attn_chunk} must divide the mid-block token count "
                    f"{n} (= T·H·W after downsampling); pick a divisor of {n}")
            out = memory_efficient_attention(q, k, v, self.attn_chunk, self.attn_impl)
        else:
            out = dense_attention(q, k, v)
        return x + self.proj_out(ncdhw(out.reshape(b, t, h, w, c)))


class Downsample3D(nn.Module):
    """Stride-2 VALID 3×3×3 conv after a (0, 1) pad of T, H and W (reference
    tae.py:93-104); always ``F.conv3d``, as the JAX "pallas" impl keeps it off
    the kernel. With a ``context`` group the T pad is the next rank's first
    frame (zeros on the last rank), so each rank's even T block gives its
    half of the output frames."""

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv3d(channels, channels, 3, stride=2, dtype=dtype)
        self.context = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.context is None:
            x = F.pad(x, (0, 1, 0, 1, 0, 1))
        else:
            x = F.pad(halo(x.to(self.conv.dtype), 0, 1, self.context), (0, 1, 0, 1))
        return self.conv(x.contiguous(memory_format=torch.channels_last_3d))


class Upsample3D(nn.Module):
    """Nearest 2× in T, H and W, then a 3×3×3 conv (reference tae.py:107-117),
    the direct form for every ``upsample_impl``."""

    def __init__(self, channels: int, dtype: torch.dtype, conv3d_impl: str = "direct"):
        super().__init__()
        self.conv = Conv3d(channels, channels, 3, padding=1, dtype=dtype, impl=conv3d_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x_3d(x))


class DownLevel3D(nn.Module):
    def __init__(self, block_in: int, block_out: int, num_res_blocks: int,
                 has_downsample: bool, dtype: torch.dtype, fused_swish: bool,
                 conv3d_impl: str, remat_policy: Optional[str] = None):
        super().__init__()
        self.remat_policy = remat_policy
        self.block = nn.ModuleList(
            ResnetBlock3D(block_in if i == 0 else block_out, block_out, dtype, fused_swish,
                          conv3d_impl, remat_policy)
            for i in range(num_res_blocks)
        )
        self.downsample = Downsample3D(block_out, dtype) if has_downsample else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return remat_call(self._forward, self.remat_policy, h)

    def _forward(self, h: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            h = blk(h)
        if self.downsample is not None:
            h = self.downsample(h)
        return h


class UpLevel3D(nn.Module):
    def __init__(self, block_in: int, block_out: int, num_res_blocks: int,
                 has_upsample: bool, dtype: torch.dtype, fused_swish: bool,
                 conv3d_impl: str, remat_policy: Optional[str] = None):
        super().__init__()
        self.remat_policy = remat_policy
        self.block = nn.ModuleList(
            ResnetBlock3D(block_in if i == 0 else block_out, block_out, dtype, fused_swish,
                          conv3d_impl, remat_policy)
            for i in range(num_res_blocks + 1)
        )
        self.upsample = Upsample3D(block_out, dtype, conv3d_impl) if has_upsample else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return remat_call(self._forward, self.remat_policy, h)

    def _forward(self, h: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            h = blk(h)
        if self.upsample is not None:
            h = self.upsample(h)
        return h


class Mid3D(nn.Module):
    """block_1, the AttnBlock3D ``attn_1``, block_2."""

    def __init__(self, channels: int, dtype: torch.dtype, fused_swish: bool,
                 conv3d_impl: str, attn_chunk: int, attn_impl: str,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.block_1 = ResnetBlock3D(channels, channels, dtype, fused_swish, conv3d_impl,
                                     remat_policy)
        self.attn_1 = AttnBlock3D(channels, dtype, attn_chunk, attn_impl)
        self.block_2 = ResnetBlock3D(channels, channels, dtype, fused_swish, conv3d_impl,
                                     remat_policy)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder3D(nn.Module):
    """Reference tae.py:120-184; conv_out emits 2·z_channels when double_z."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, in_channels: int = 3, double_z: bool = True,
                 dtype: torch.dtype = torch.float32, fused_swish: bool = False,
                 conv3d_impl: str = "direct", attn_chunk: int = 0, attn_impl: str = "auto",
                 remat_policy: Optional[str] = None):
        super().__init__()
        n = len(ch_mult)
        self.fused_swish = fused_swish
        self.conv_in = Conv3d(in_channels, ch, 3, padding=1, dtype=dtype, impl=conv3d_impl)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList(
            DownLevel3D(ch * in_mult[i], ch * ch_mult[i], num_res_blocks, i != n - 1, dtype,
                        fused_swish, conv3d_impl, remat_policy)
            for i in range(n)
        )
        block_in = ch * ch_mult[-1]
        self.mid = Mid3D(block_in, dtype, fused_swish, conv3d_impl, attn_chunk, attn_impl,
                         remat_policy)
        self.norm_out = FP32GroupNorm(block_in, fused_swish=fused_swish)
        self.conv_out = Conv3d(block_in, z_channels * (2 if double_z else 1), 3, padding=1,
                               dtype=dtype, impl=conv3d_impl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.norm_out(self.mid(h))
        return self.conv_out(h if self.fused_swish else F.silu(h))


class Decoder3D(nn.Module):
    """Reference tae.py:187-250."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, dtype: torch.dtype = torch.float32,
                 fused_swish: bool = False, conv3d_impl: str = "direct",
                 attn_chunk: int = 0, attn_impl: str = "auto",
                 remat_policy: Optional[str] = None):
        super().__init__()
        n = len(ch_mult)
        self.fused_swish = fused_swish
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv3d(z_channels, block_in, 3, padding=1, dtype=dtype, impl=conv3d_impl)
        self.mid = Mid3D(block_in, dtype, fused_swish, conv3d_impl, attn_chunk, attn_impl,
                         remat_policy)
        level_in = [ch * ch_mult[min(i + 1, n - 1)] for i in range(n)]
        self.up = nn.ModuleList(
            UpLevel3D(level_in[i], ch * ch_mult[i], num_res_blocks, i != 0, dtype, fused_swish,
                      conv3d_impl, remat_policy)
            for i in range(n)
        )
        self.norm_out = FP32GroupNorm(ch * ch_mult[0], fused_swish=fused_swish)
        self.conv_out = Conv3d(ch * ch_mult[0], out_ch, 3, padding=1, dtype=dtype,
                               impl=conv3d_impl)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        h = self.norm_out(h)
        return self.conv_out(h if self.fused_swish else F.silu(h))


def _check_ported(cfg: TVAEConfig) -> None:
    if cfg.reg_type not in ("gaussian", "vq"):
        raise ValueError(f"unknown reg_type {cfg.reg_type!r}")
    if cfg.conv3d_impl not in CONV3D_IMPLS:
        raise ValueError(f"unknown conv3d_impl {cfg.conv3d_impl!r}")


def check_context_frames(frames: int, ch_mult: Sequence[int], n_context: int) -> None:
    """JAX ``Trainer3D``'s check (``trainer3d.py:199-207``): the clip's T
    after the encoder's downsamples must split evenly over the context
    ranks, so that every level's T block is whole (and even where it is
    downsampled)."""
    t_mid = frames // 2 ** (len(ch_mult) - 1)
    if t_mid % n_context:
        raise ValueError(
            f"mid-block temporal extent {t_mid} (frames {frames} / "
            f"2^{len(ch_mult) - 1} downsamples) must divide "
            f"by the context extent {n_context}")


class TVAE(nn.Module):
    """Encoder + real DiagonalGaussian (or VQ) + decoder (reference
    tae.py:269-297).

    ``context``: a process group whose ranks each hold a contiguous block of
    every clip's T frames (JAX ``TVAE(mesh, ring_axis="context")``; the
    module docstring says how the model computes on them); ``encode``
    checks the clip's frames against it (``check_context_frames``). Params
    are allocated, not initialized: load a state dict, or use
    ``init_tvae``."""

    def __init__(self, cfg: TVAEConfig, context=None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.context = context
        dtype = DTYPES[cfg.compute_dtype]
        kw = dict(dtype=dtype, fused_swish=cfg.fused_gn_swish, conv3d_impl=cfg.conv3d_impl,
                  attn_chunk=cfg.attn_chunk, attn_impl=cfg.attn_impl,
                  remat_policy=remat_policy_of(cfg.remat, cfg.remat_policy))
        self.encoder = Encoder3D(cfg.ch, cfg.ch_mult, cfg.num_res_blocks, cfg.z_channels,
                                 in_channels=cfg.in_channels,
                                 double_z=cfg.reg_type == "gaussian", **kw)
        self.decoder = Decoder3D(cfg.ch, cfg.out_ch, cfg.ch_mult, cfg.num_res_blocks,
                                 cfg.z_channels, **kw)
        if cfg.reg_type == "vq":
            self.reg = VectorQuantizer(cfg.vq_codebook_size, cfg.z_channels, cfg.vq_beta,
                                       cfg.vq_ema_decay)
        else:
            self.reg = DiagonalGaussian()
        for m in self.modules():
            if isinstance(m, (Conv3d, FP32GroupNorm, Downsample3D, AttnBlock3D)):
                m.context = context

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, in_channels) → (B, t, h, w, z or 2·z) in the compute
        dtype; with a context group x is this rank's T block and so is the
        latent."""
        if self.context is not None:
            check_context_frames(x.shape[1] * group_size(self.context), self.cfg.ch_mult,
                                 group_size(self.context))
        return _ndhwc(self.encoder(ncdhw(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, t, h, w, z) → (B, T, H, W, out_ch) in the compute dtype."""
        return _ndhwc(self.decoder(ncdhw(z)))

    def regularize(self, z: torch.Tensor, ema_state: Optional[dict] = None,
                   update_stats: bool = False, group=None):
        """The Gaussian's sample in z's dtype, or for VQ the quantizer's
        ``(z_q, aux, new_ema)``, its statistics summed across ``group``'s
        ranks where one is given."""
        if isinstance(self.reg, VectorQuantizer):
            return self.reg(z, ema_state, update_stats, group)
        return self.reg(z)

    def deterministic_latent(self, z: torch.Tensor) -> torch.Tensor:
        """The serving latent of an encoder output: the posterior mean (split
        in fp32, cast back) for the Gaussian, the quantized latent for VQ."""
        if isinstance(self.reg, VectorQuantizer):
            return self.reg.quantize(z)
        return z.float().chunk(2, dim=-1)[0].to(z.dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(decoded, z)`` like the reference; VQ quantizes without
        statistics, the Gaussian samples."""
        z = self.encode(x)
        if isinstance(self.reg, VectorQuantizer):
            z_s = self.reg.quantize(z)
        else:
            z_s = self.regularize(z)
        return self.decode(z_s), z


def reparameterize(z: torch.Tensor, eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Gaussian latent's training sample and its KL, as the JAX 3D steps
    take them (``vqgan_tpu/train/step3d.py:90-97``, ``trainer3d.py:56-63``):
    z (..., 2·z_channels) split in fp32 into mean and logvar, logvar clipped
    at −3, z_s = mean + exp(logvar/2)·ε cast back to z's dtype, and
    KL = ½·mean(μ² + e^logvar − 1 − logvar). ``eps`` has the mean's shape."""
    mean, logvar = z.float().chunk(2, dim=-1)
    logvar = logvar.clamp(min=-3.0)
    z_s = (mean + torch.exp(0.5 * logvar) * eps).to(z.dtype)
    kl = 0.5 * (mean.square() + torch.exp(logvar) - 1.0 - logvar).mean()
    return z_s, kl


def init_tvae(cfg: TVAEConfig, generator: torch.Generator) -> TVAE:
    """A TVAE on the CPU with the reference init, drawn from ``generator``."""
    model = TVAE(cfg)
    init_weights_(model, generator)
    return model
