"""2D image VAE (counterpart of ``vqgan_tpu/models/ae.py``).

Encoder: conv_in → per-level ResnetBlocks + Downsample (not at the last
level) → mid (block_1, attn_1 with ``use_attn``, block_2) → GroupNorm+swish →
conv_out. In wavelet mode (``use_wavelet``) the wavelet transform
(``ops/wavelet.py``) comes first, conv_in maps 4·in_channels to 2·ch,
ch_mult[0] is doubled and level 0 has no Downsample (JAX ``ae.py:114-131``).
Decoder: conv_in ← z → mid → levels in reverse, each (num_res_blocks + 1)
ResnetBlocks + Upsample (not at level 0) → GroupNorm+swish → conv_out; it
takes ``cfg.decoder_ch_mult`` (the HR level, the wavelet quirk).

With ``remat`` (JAX ``ae.py:58, 81, 127, 146, 183, 191``) each level is a
rematerialized region, its ResnetBlocks regions nested inside it, and the
mid blocks regions of their own (``blocks.remat_call``).

Module names give the reference state-dict keys, e.g.
``encoder.down.0.block.1.conv1.weight``, ``encoder.mid.block_1.norm1.weight``,
``decoder.up.2.upsample.conv.bias``; ``decoder.up`` is indexed by level and
walked in reverse.

``VAE.encode``/``decode``/``forward`` keep the JAX package's layout: images
(B, H, W, C) and latents (B, h, w, z). Inside, tensors are (B, C, H, W) in
``torch.channels_last`` memory format.

With a ``context`` process group (``VAE(cfg, context=group)``; JAX's GSPMD
run of the same model on a batch whose H is sharded over ``context``) each
rank holds a contiguous block of every image's H rows and the model
computes the whole image's function on it (``models/blocks.py`` says how
each module does); ``encode`` checks the image's rows against the group
(``check_context_rows``). The HDR recipe's wavelet front end and HR decoder
are not ported under it (``CONTEXT_HDR``). The parameter tree is the same
with or without it.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
import torch.nn as nn

from vqgan_tpu_torch.config import DTYPES, VAEConfig
from vqgan_tpu_torch.models.blocks import (
    AttnBlock,
    Conv2d,
    Downsample,
    FP32GroupNorm,
    ResnetBlock,
    Upsample,
    conv3x3,
    init_weights_,
    nchw,
    remat_call,
    remat_policy_of,
)
from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.ops.wavelet import wavelet_transform_nchw
from vqgan_tpu_torch.parallel.mesh import group_size

# the ROADMAP.md item that ports the HDR recipe's options under the 2D
# context axis
CONTEXT_HDR = "ROADMAP.md, Queue 1: context: the 2D HDR options"


class DownLevel(nn.Module):
    def __init__(self, block_in: int, block_out: int, num_res_blocks: int,
                 has_downsample: bool, dtype: torch.dtype,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.remat_policy = remat_policy
        self.block = nn.ModuleList(
            ResnetBlock(block_in if i == 0 else block_out, block_out, dtype, remat_policy)
            for i in range(num_res_blocks)
        )
        self.downsample = Downsample(block_out, dtype) if has_downsample else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return remat_call(self._forward, self.remat_policy, h)

    def _forward(self, h: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            h = blk(h)
        if self.downsample is not None:
            h = self.downsample(h)
        return h


class UpLevel(nn.Module):
    def __init__(self, block_in: int, block_out: int, num_res_blocks: int,
                 has_upsample: bool, dtype: torch.dtype,
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.remat_policy = remat_policy
        self.block = nn.ModuleList(
            ResnetBlock(block_in if i == 0 else block_out, block_out, dtype, remat_policy)
            for i in range(num_res_blocks + 1)
        )
        self.upsample = Upsample(block_out, dtype) if has_upsample else None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return remat_call(self._forward, self.remat_policy, h)

    def _forward(self, h: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            h = blk(h)
        if self.upsample is not None:
            h = self.upsample(h)
        return h


class Mid(nn.Module):
    """block_1, the AttnBlock ``attn_1`` when ``use_attn``, block_2 (JAX
    ``ae.py:146-153``)."""

    def __init__(self, channels: int, dtype: torch.dtype, use_attn: bool = False,
                 attn_chunk: int = 0, attn_impl: str = "auto",
                 remat_policy: Optional[str] = None):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, dtype, remat_policy)
        self.attn_1 = (AttnBlock(channels, dtype, attn_chunk=attn_chunk, attn_impl=attn_impl)
                       if use_attn else None)
        self.block_2 = ResnetBlock(channels, channels, dtype, remat_policy)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.block_1(h)
        if self.attn_1 is not None:
            h = self.attn_1(h)
        return self.block_2(h)


class Encoder(nn.Module):
    """Reference ae.py:170-257. Emits z_channels, or 2·z_channels (mean,
    logvar) with ``double_z``; ``use_wavelet``: the wavelet front end
    (reference ae.py:188-203)."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, in_channels: int = 3, double_z: bool = False,
                 dtype: torch.dtype = torch.float32, use_attn: bool = False,
                 attn_chunk: int = 0, attn_impl: str = "auto",
                 use_wavelet: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        n = len(ch_mult)
        self.use_wavelet = use_wavelet
        ch_mult = list(ch_mult)
        stem = ch
        if use_wavelet:
            ch_mult[0] *= 2
            stem, in_channels = 2 * ch, 4 * in_channels
        self.conv_in = conv3x3(in_channels, stem, dtype)
        level_in = [stem] + [ch * m for m in ch_mult[:-1]]
        self.down = nn.ModuleList(
            DownLevel(level_in[i], ch * ch_mult[i], num_res_blocks,
                      has_downsample=i != n - 1 and not (use_wavelet and i == 0),
                      dtype=dtype, remat_policy=remat_policy)
            for i in range(n)
        )
        block_in = ch * ch_mult[-1]
        self.mid = Mid(block_in, dtype, use_attn, attn_chunk, attn_impl, remat_policy)
        self.norm_out = FP32GroupNorm(block_in, fused_swish=True)
        self.conv_out = conv3x3(block_in, z_channels * (2 if double_z else 1), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_wavelet:
            x = wavelet_transform_nchw(x).contiguous(memory_format=torch.channels_last)
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        return self.conv_out(self.norm_out(self.mid(h)))


class Decoder(nn.Module):
    """Reference ae.py:260-333."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int],
                 num_res_blocks: int, z_channels: int,
                 dtype: torch.dtype = torch.float32, use_attn: bool = False,
                 attn_chunk: int = 0, attn_impl: str = "auto",
                 remat_policy: Optional[str] = None):
        super().__init__()
        n = len(ch_mult)
        block_in = ch * ch_mult[-1]
        self.conv_in = conv3x3(z_channels, block_in, dtype)
        self.mid = Mid(block_in, dtype, use_attn, attn_chunk, attn_impl, remat_policy)
        level_in = [ch * ch_mult[min(i + 1, n - 1)] for i in range(n)]
        self.up = nn.ModuleList(
            UpLevel(level_in[i], ch * ch_mult[i], num_res_blocks,
                    has_upsample=i != 0, dtype=dtype, remat_policy=remat_policy)
            for i in range(n)
        )
        self.norm_out = FP32GroupNorm(ch * ch_mult[0], fused_swish=True)
        self.conv_out = conv3x3(ch * ch_mult[0], out_ch, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(self.norm_out(h))


class IdentityGaussian(nn.Module):
    """The reference's degenerate constant-variance regularizer: z is the
    mean, std=0.0 → deterministic identity (ae.py:336-348)."""

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return z


class DiagonalGaussian(nn.Module):
    """Reparameterized Gaussian over a 2·z_channels input (reference
    tae.py:253-266; JAX ``models/ae.py::DiagonalGaussian``): split into mean
    and logvar in z's dtype, clip logvar at −3, mean + exp(logvar/2)·ε. ε has
    the mean's shape and dtype: the train step draws it on its state's
    generator (``train/step.py::draw_step``), eval on a generator seeded 0
    (``train/evaluate.py``), and both pass it; without it ε comes from
    torch's default generator (a plain ``VAE``/``TVAE`` forward). Serving
    takes the mean (``VAEPipeline.encode``)."""

    def forward(self, z: torch.Tensor, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        mean, logvar = z.chunk(2, dim=-1)
        std = torch.exp(0.5 * logvar.clamp(min=-3.0))
        return mean + std * (torch.randn_like(mean) if eps is None else eps)


def _check_config(cfg: VAEConfig) -> None:
    if cfg.reg_type not in ("identity_gaussian", "gaussian", "vq"):
        raise ValueError(f"unknown reg_type {cfg.reg_type!r}")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def check_context_rows(rows: int, ch_mult: Sequence[int], n_context: int) -> None:
    """The image sizes whose rows split evenly at every level over
    ``n_context`` ranks: each rank's block of the latent's rows (the image's
    over the encoder's 2^(levels - 1)) whole, so that every downsample
    halves an even block. JAX's ``Trainer`` checks only ``image_size %
    n_context`` (``trainer.py:65-69``; its GSPMD pads uneven blocks), which
    this check implies; raises ValueError naming the sizes that pass."""
    step = n_context * 2 ** (len(ch_mult) - 1)
    if rows % step:
        raise ValueError(
            f"{rows} image rows do not split evenly over {n_context} context ranks at every "
            f"level of ch_mult {tuple(ch_mult)}: each rank's block of the latent's rows must "
            f"be whole, so the rows must be a multiple of {n_context} x "
            f"{2 ** (len(ch_mult) - 1)} = {step}")


class VAE(nn.Module):
    """Encoder + regularizer + decoder (reference ae.py:351-392).

    ``context``: a process group whose ranks each hold a contiguous block of
    every image's H rows (the module docstring says how the model computes
    on them). Params are allocated, not initialized: load a state dict, or
    use ``init_vae``."""

    def __init__(self, cfg: VAEConfig, context=None):
        super().__init__()
        _check_config(cfg)
        if context is not None and (cfg.use_wavelet or cfg.decoder_also_perform_hr):
            raise NotImplementedError(
                f"use_wavelet={cfg.use_wavelet}, decoder_also_perform_hr="
                f"{cfg.decoder_also_perform_hr} over H blocks of the context axis: not ported "
                f"yet ({CONTEXT_HDR})")
        self.cfg = cfg
        self.context = context
        attn = dict(use_attn=cfg.use_attn, attn_chunk=cfg.attn_chunk,
                    attn_impl=cfg.attn_impl,
                    remat_policy=remat_policy_of(cfg.remat, cfg.remat_policy))
        self.encoder = Encoder(
            cfg.ch, cfg.ch_mult, cfg.num_res_blocks, cfg.z_channels,
            in_channels=cfg.in_channels,
            double_z=cfg.reg_type == "gaussian",
            dtype=DTYPES[cfg.enc_dtype],
            use_wavelet=cfg.use_wavelet,
            **attn,
        )
        self.decoder = Decoder(
            cfg.ch, cfg.out_ch, cfg.decoder_ch_mult, cfg.num_res_blocks,
            cfg.z_channels, dtype=DTYPES[cfg.dec_dtype], **attn,
        )
        if cfg.reg_type == "vq":  # JAX ae.py:283-289
            self.reg = VectorQuantizer(cfg.vq_codebook_size, cfg.z_channels,
                                       cfg.vq_beta, cfg.vq_ema_decay)
        elif cfg.reg_type == "identity_gaussian":
            self.reg = IdentityGaussian()
        else:
            self.reg = DiagonalGaussian()
        for m in self.modules():
            if isinstance(m, (Conv2d, FP32GroupNorm, Downsample, AttnBlock)):
                m.context = context

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, in_channels) → (B, h, w, z) in the encoder's dtype; with
        a context group x is this rank's block of H rows and so is the
        latent."""
        if self.context is not None:
            n = group_size(self.context)
            check_context_rows(x.shape[1] * n, self.cfg.ch_mult, n)
        return _nhwc(self.encoder(nchw(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, z) → (B, H, W, out_ch) in the decoder's dtype; with a
        context group z is this rank's block of rows and so is the output."""
        return _nhwc(self.decoder(nchw(z)))

    def decode_whole(self, z: torch.Tensor) -> torch.Tensor:
        """``decode`` of whole latents on this rank alone, whatever the
        context group: the decoder's modules again, sharing its parameters
        (their gradients accumulate on them), without the group. The train
        step decodes a crop window whose rows do not split over the ranks
        so (``train/step.py``)."""
        whole = self.__dict__.get("_whole_decoder")
        if whole is None:
            # a copy of the module tree that keeps the parameter tensors (and
            # the group, which cannot be copied)
            keep = {id(p): p for p in self.decoder.parameters()}
            keep[id(self.context)] = self.context
            whole = copy.deepcopy(self.decoder, keep)
            for m in whole.modules():
                if hasattr(m, "context"):
                    m.context = None
            self.__dict__["_whole_decoder"] = whole
        return _nhwc(whole(nchw(z)))

    def regularize(self, z: torch.Tensor, ema_state: Optional[dict] = None,
                   update_stats: bool = False, eps: Optional[torch.Tensor] = None,
                   group=None):
        """z_s for the Gaussian kinds (the sampled one takes ``eps``); for VQ
        the quantizer's ``(z_q, aux, new_ema)`` (JAX ae.py:299-306, where
        ``new_ema`` is the mutable ``vq_ema`` collection's new value), its
        statistics summed across ``group``'s ranks where one is given."""
        if isinstance(self.reg, VectorQuantizer):
            return self.reg(z, ema_state, update_stats, group)
        if isinstance(self.reg, DiagonalGaussian):
            return self.reg(z, eps)
        return self.reg(z)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns ``(decoded, z)`` like the reference; VQ quantizes without
        statistics (JAX ae.py:308-315); the Gaussian samples with ``eps``
        (by default from torch's default generator)."""
        z = self.encode(x)
        if isinstance(self.reg, VectorQuantizer):
            z_s = self.reg.quantize(z)
        else:
            z_s = self.regularize(z, eps=eps)
        return self.decode(z_s), z


def init_vae(cfg: VAEConfig, generator: torch.Generator) -> VAE:
    """A VAE on the CPU with the reference init scheme, drawn from
    ``generator``."""
    model = VAE(cfg)
    init_weights_(model, generator)
    return model
