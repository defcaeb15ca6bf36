"""Inference pipeline: load a reference-format ``.pt`` and encode/decode
images on an explicit device (counterpart of ``vqgan_tpu/inference.py``).

    from vqgan_tpu_torch.inference import VAEPipeline
    pipe = VAEPipeline.from_checkpoint("vae.pt", VAEConfig(), device="cuda")
    z = pipe.encode(images)          # (B,H,W,3) uint8/float → latents (B,h,w,z)
    recon = pipe.decode(z)           # latents → float images in [0,1], numpy

CLI:  python -m vqgan_tpu_torch.inference --checkpoint vae.pt --images 'a.png b.png'
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping

import numpy as np
import torch

from vqgan_tpu_torch.config import VAEConfig, parse_ch_mult
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.weights import load_weights


def check_reg_matches_params(cfg: VAEConfig, state_dict: Mapping) -> None:
    """A VQ-trained checkpoint carries ``reg.codebook``; serving it with a
    non-vq config would silently skip quantization. Fail loudly instead."""
    has_codebook = "reg.codebook" in state_dict
    if has_codebook and cfg.reg_type != "vq":
        raise ValueError(
            "checkpoint contains a VQ codebook (reg.codebook) but reg_type is "
            f"'{cfg.reg_type}' — pass --reg_type vq, or the served latents "
            "would silently bypass quantization"
        )
    if cfg.reg_type == "vq" and not has_codebook:
        raise ValueError("reg_type='vq' but the checkpoint has no codebook")


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "t", "yes", "y", "on"):
        return True
    if v in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"{s!r} is not a boolean")


def add_vae_arch_args(parser: argparse.ArgumentParser) -> None:
    """The --vae_* flags of the JAX package's inference and export commands,
    with the same names and defaults."""
    parser.add_argument("--vae_ch", type=int, default=256)
    parser.add_argument("--vae_ch_mult", type=str, default="1,2,4,4")
    parser.add_argument("--vae_z_channels", type=int, default=16)
    parser.add_argument("--vae_num_res_blocks", type=int, default=2)
    parser.add_argument("--vae_resolution", type=int, default=256)
    parser.add_argument("--use_wavelet", type=_bool, default=False)
    parser.add_argument("--do_attn", type=_bool, default=False)
    parser.add_argument("--decoder_also_perform_hr", type=_bool, default=False)
    parser.add_argument("--reg_type", type=str, default="identity_gaussian",
                        help="identity_gaussian | gaussian | vq")
    parser.add_argument("--vq_codebook_size", type=int, default=16384)


def build_vae_config(kw: Mapping) -> VAEConfig:
    """VAEConfig from the --vae_* arguments (vq_ema_decay 0 for serving)."""
    return VAEConfig(
        resolution=kw["vae_resolution"],
        ch=kw["vae_ch"],
        ch_mult=parse_ch_mult(kw["vae_ch_mult"]),
        z_channels=kw["vae_z_channels"],
        num_res_blocks=kw["vae_num_res_blocks"],
        use_wavelet=kw["use_wavelet"],
        use_attn=kw["do_attn"],
        decoder_also_perform_hr=kw["decoder_also_perform_hr"],
        reg_type=kw["reg_type"],
        vq_codebook_size=kw["vq_codebook_size"],
        vq_ema_decay=0.0,
    )


class VAEPipeline:
    """Serving path of the 2D VAE: encode (then clamp to ±clamp_th, and take
    the Gaussian mean or the nearest codebook entries where the config has
    them), decode, reconstruct. Runs under ``torch.inference_mode()`` on
    ``device``."""

    def __init__(self, cfg: VAEConfig, state_dict: Mapping[str, torch.Tensor],
                 *, device: str | torch.device, do_clamp: bool = True,
                 clamp_th: float = 8.0):
        check_reg_matches_params(cfg, state_dict)
        self.cfg = cfg
        self.device = torch.device(device)
        self.do_clamp = do_clamp
        self.clamp_th = clamp_th
        with torch.device(self.device):
            self.model = VAE(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        # params in the layout the convs and the GroupNorm kernel read, once
        self.model.to(memory_format=torch.channels_last).eval()

    @classmethod
    def from_checkpoint(cls, path: str, cfg: VAEConfig, *,
                        device: str | torch.device, **kw) -> "VAEPipeline":
        return cls(cfg, load_weights(path), device=device, **kw)

    def _to_device(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))  # a writable host copy
        return a.to(self.device)

    def _to_model_input(self, images) -> torch.Tensor:
        x = self._to_device(images)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        if x.ndim == 3:
            x = x[None]
        return x.float()

    @torch.inference_mode()
    def encode(self, images) -> torch.Tensor:
        """Images (B,H,W,3) uint8 [0,255] or float [-1,1] → latents (B,h,w,z)
        on the device, clamped to ±clamp_th like the published model; for VQ
        the nearest-code embeddings (the search and the gather only: the
        statistics the JAX package's jit drops are never computed)."""
        z = self.model.encode(self._to_model_input(images))
        if self.do_clamp:
            z = z.clamp(-self.clamp_th, self.clamp_th)
        if self.cfg.reg_type == "gaussian":
            z = z.chunk(2, dim=-1)[0]  # mean
        elif self.cfg.reg_type == "vq":
            z = self.model.reg.quantize(z)
        return z

    @torch.inference_mode()
    def decode(self, z) -> np.ndarray:
        """Latents (B,h,w,z) → float images (B,H,W,3) in [0,1], on the host."""
        dec = self.model.decode(self._to_device(z)).float()
        return (dec * 0.5 + 0.5).clamp(0.0, 1.0).cpu().numpy()

    def reconstruct(self, images) -> np.ndarray:
        return self.decode(self.encode(images))


def _main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m vqgan_tpu_torch.inference",
        description="Reconstruct images through a VAE checkpoint.",
    )
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--images", default="", help="space-separated image paths")
    parser.add_argument("--clips", default="",
                        help="space-separated .npy uint8 (T,H,W,3) clip paths "
                             "(3D pipeline; not ported yet)")
    parser.add_argument("--out_dir", default="./recon")
    parser.add_argument("--device", default="cuda")
    add_vae_arch_args(parser)
    args = parser.parse_args(argv)

    if bool(args.images) == bool(args.clips):
        parser.error("pass exactly one of --images / --clips")
    if args.clips:
        raise NotImplementedError(
            "--clips: the 3D video pipeline waits for the TVAE port "
            "(ROADMAP.md, Queue 1: 3D family)"
        )
    from PIL import Image  # image files only; the pipeline needs no PIL

    cfg = build_vae_config(vars(args))
    pipe = VAEPipeline.from_checkpoint(args.checkpoint, cfg, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    for path in args.images.split():
        s = cfg.resolution
        img = Image.open(path).convert("RGB").resize((s, s))
        recon = pipe.reconstruct(np.asarray(img, np.uint8))[0]
        out_path = os.path.join(
            args.out_dir, os.path.splitext(os.path.basename(path))[0] + "_recon.png"
        )
        Image.fromarray((recon * 255).astype(np.uint8)).save(out_path)
        print(f"{path} -> {out_path}")


if __name__ == "__main__":
    _main()
