"""Model configuration (counterpart of ``vqgan_tpu/config.py::VAEConfig``).

Every field of the JAX package's ``VAEConfig`` is here with the same name and
default, so a configuration built from the JAX package's arguments builds here
too. Fields that only steer TPU lowerings are accepted and have no effect.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

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
      - ``remat``, ``remat_policy``: activation rematerialization is a training
        memory lever; serving keeps no activations for a backward;
      - ``upsample_impl``: "fused", "dilated" and "auto" compute the same
        function with the same params as "direct" (TPU lowerings); every value
        runs the direct nearest-2× + conv form;
      - ``attn_chunk``, ``attn_impl``: only read with ``use_attn``.

    Not ported yet (model construction raises NotImplementedError):
    ``use_attn``, ``use_wavelet`` and ``reg_type="vq"``.
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


def parse_ch_mult(s: str | Sequence[int]) -> Tuple[int, ...]:
    """Parse the reference's comma-string ch_mult flag ("1,2,4,4")."""
    if isinstance(s, str):
        return tuple(int(x) for x in s.split(","))
    return tuple(int(x) for x in s)
