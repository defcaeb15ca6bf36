"""Model and training configuration (counterpart of ``vqgan_tpu/config.py``:
``VAEConfig``, ``TVAEConfig`` and ``TrainConfig``).

Every field of the JAX package's three configs is here with the same name and
default, so a configuration built from the JAX package's arguments builds here
too. Fields that only steer TPU lowerings, or parts not ported yet, are
accepted and listed in each docstring.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """2D image VAE architecture config (reference ae.py:351-392).

    ``reg_type``: "identity_gaussian" (the reference's deterministic
    constant-variance Gaussian), "gaussian" (encoder emits 2·z_channels:
    mean, logvar) or "vq".

    Dtype policy: params are fp32; the encoder computes in ``enc_dtype``, the
    decoder in ``dec_dtype``; GroupNorm always computes in fp32 and returns its
    input's dtype.

    No effect in this package:
      - ``use_pallas_gn``: on CUDA the hand-written GroupNorm kernel is the only
        GroupNorm (``ops/groupnorm_cuda.py``); a CPU tensor takes its plain
        version;
      - ``upsample_impl``: "fused", "dilated" and "auto" compute the same
        function with the same params as "direct" (TPU lowerings); every value
        runs the direct nearest-2× + conv form;
      - ``attn_impl``: "auto", "pallas" and "lax" pick the JAX package's
        attention lowering; here a CUDA tensor always runs the hand-written
        flash-attention kernel (``ops/attention_cuda.py``) and a CPU tensor
        its chunked plain version. Another value raises ValueError, as in the
        JAX package.

    ``use_attn`` adds the mid-block AttnBlock to the encoder and the decoder.
    ``attn_chunk`` (read only with ``use_attn``): 0, or a token count at or
    above the mid block's, runs dense attention; else the memory-efficient
    path, and it must divide the mid block's H·W. The kernel picks its own
    tiles, so on the card the value only selects the path; on the CPU it is
    the plain version's k/v chunk.

    ``use_wavelet``: the wavelet front end (``ops/wavelet.py``) before the
    encoder's conv_in, ch_mult[0] doubled, no downsample at level 0.

    ``remat``: where autograd records, each encoder and decoder level is a
    ``torch.utils.checkpoint`` region, its ResnetBlocks regions nested in it,
    and each mid block one too (``models/blocks.py::remat_call``); the train
    steps also recompute LPIPS and D. ``remat_policy``: "full" keeps only a
    region's inputs, "conv" also its conv outputs; another value raises
    ValueError. Serving (no autograd) is unchanged.
    """

    resolution: int = 256
    in_channels: int = 3
    ch: int = 256
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    use_attn: bool = False
    decoder_also_perform_hr: bool = False
    use_wavelet: bool = False
    reg_type: str = "identity_gaussian"
    vq_codebook_size: int = 16384
    vq_beta: float = 0.25
    vq_ema_decay: float = 0.99
    vq_revive_threshold: float = 0.0
    enc_dtype: str = "float32"
    dec_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "full"
    use_pallas_gn: bool = False
    attn_chunk: int = 0
    attn_impl: str = "auto"
    upsample_impl: str = "auto"

    @property
    def ffactor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def decoder_ch_mult(self) -> Tuple[int, ...]:
        # HR decode: one extra upsample level (reference ae.py:381).
        # Wavelet quirk: the reference Encoder mutates the shared ch_mult list
        # (ch_mult[0] *= 2, ae.py:194) before the Decoder is built from it, so
        # wavelet mode doubles the decoder's level-0 width too.
        mult = tuple(self.ch_mult)
        if self.use_wavelet:
            mult = (mult[0] * 2,) + mult[1:]
        return mult + ((4,) if self.decoder_also_perform_hr else ())


CONV3D_IMPLS = ("auto", "direct", "tap2d", "tap2dfat", "pallas", "mixed")


@dataclasses.dataclass(frozen=True)
class TVAEConfig:
    """3D video VAE architecture config (reference tae.py:269-297).

    ``reg_type``: "gaussian" (encoder emits 2·z_channels: mean, logvar) or
    "vq". Params are fp32; the model computes in ``compute_dtype``; GroupNorm
    always computes in fp32 and returns its input's dtype.

    ``conv3d_impl`` keeps the JAX values; here it picks what computes each
    stride-1 3×3×3 SAME conv:
      - "pallas", and "auto" on a CUDA device: the hand-written fused-tap
        kernel (kernel #6, ``ops/conv3d_cuda.py``); on the CPU "pallas" runs
        its plain version and "auto" is "direct";
      - "mixed": the kernel where min(Ci, Co) >= 128, as the JAX package's
        per-width split (``vqgan_tpu/models/tae.py:325-343``), else "direct";
      - "direct", "tap2d", "tap2dfat": ``F.conv3d``. The tap lowerings are TPU
        forms of the same function with the same params.
    The stride-2 downsample conv always runs ``F.conv3d``, as the JAX
    "pallas" keeps it off the kernel.

    ``remat``, ``remat_policy``: as in ``VAEConfig``, over the 3D levels and
    mid blocks.

    No effect in this package: ``upsample_impl`` (every value runs the direct
    nearest-2× + conv form, as ``VAEConfig`` says); ``attn_impl`` (as in ``VAEConfig``: a CUDA tensor runs kernel #3, a CPU
    tensor its chunked plain version). ``attn_chunk``: 0, or a token count at
    or above the mid block's T·H·W, runs dense attention; else the
    memory-efficient path, and it must divide T·H·W.
    """

    resolution: int = 256
    in_channels: int = 3
    ch: int = 64
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 16
    reg_type: str = "gaussian"
    vq_codebook_size: int = 16384
    vq_beta: float = 0.25
    vq_ema_decay: float = 0.99
    vq_revive_threshold: float = 0.0
    compute_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "full"
    conv3d_impl: str = "auto"
    attn_chunk: int = 0
    attn_impl: str = "auto"
    upsample_impl: str = "auto"
    fused_gn_swish: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration; defaults match the reference CLI defaults
    (vae_trainer.py:224-338).

    The train steps (``train/step.py``, ``train/step3d.py``) read the
    optimization, objective and latent fields, the 3D steps also the video
    family's ``video_loss_frames`` and ``disc_3d``; the 2D ``Trainer``
    (``train/trainer.py``) and the ``train`` CLI read the data, run
    management and weight-file fields as the JAX trainer does. No effect in
    this package:
      - ``mesh_shape``: the port trains on one card; a mesh of several
        devices raises NotImplementedError (ROADMAP.md, Queue 1: multi-GPU);
      - ``device_normalize`` for the steps themselves: they normalize a uint8
        batch on the device whatever its value (the loader reads it).

    ``grad_accum > 1``: each step splits its batch into that many
    microbatches, and its peak memory is one microbatch's graph (the
    ``step_accum`` of ``train/step.py`` and ``train/step3d.py``).
    """

    # data
    dataset_url: str = ""
    test_dataset_url: str = ""
    batch_size: int = 8
    num_epochs: int = 2
    image_size: int = 512
    num_workers: int = 4
    synthetic_data: bool = False
    indexed_data: bool = True
    device_normalize: bool = True

    # optimization (vae_trainer.py:455-490)
    learning_rate_vae: float = 1e-5  # divided by vae_ch for all but conv_in,
    learning_rate_disc: float = 2e-4  # which gets a fixed 1e-4
    weight_decay: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    warmup_steps: int = 200
    max_steps: int = 1000
    grad_accum: int = 1
    ema_decay: float = 0.0  # Polyak average of the generator weights; 0 = off

    # objectives
    do_ganloss: bool = False
    disc_type: str = "bce"  # "bce" | "hinge"
    use_lecam: bool = False
    lecam_weight: float = 0.1
    lecam_beta: float = 0.9
    recon_weight: float = 0.0
    z_reg_weight: float = 0.1
    do_pool_recon: bool = True
    gradnorm_lpips: float = 1.0
    gradnorm_mse: float = 0.001
    gradnorm_gan: float = 1.0
    gradnorm_mode: str = "global"  # "global" | "mean_shard_norm"
    augment_before_perceptual_loss: bool = False
    lpips_weights: Optional[str] = None
    disc_backbone_weights: Optional[str] = None
    video_loss_frames: int = 0
    disc_3d: str = "frame"

    # latent behaviours (vae_trainer.py:561-621)
    do_clamp: bool = False
    clamp_th: float = 8.0
    flip_invariance: bool = False
    crop_invariance: bool = False
    downscale_factor: int = 16
    crop_fractions: Tuple[float, ...] = (0.75, 0.5, 0.875)

    # run management
    run_name: str = "run"
    project_name: str = "vae_sweep_attn_lr_width"
    evaluate_every_n_steps: int = 250
    eval_batches: int = 2
    eval_bf16: bool = True
    rfid_taps: Tuple[int, ...] = (-1,)
    load_path: Optional[str] = None
    ckpt_dir: str = "./ckpt"
    seed: int = 42
    log_every: int = 5
    use_wandb: bool = True
    nan_guard: bool = True

    # mesh
    mesh_shape: str = "data=-1"
    full_bf16: bool = False
    profile_dir: Optional[str] = None


def parse_ch_mult(s: str | Sequence[int]) -> Tuple[int, ...]:
    """Parse the reference's comma-string ch_mult flag ("1,2,4,4")."""
    if isinstance(s, str):
        return tuple(int(x) for x in s.split(","))
    return tuple(int(x) for x in s)
