"""Inference pipelines: load a reference-format ``.pt`` and encode/decode
images (``VAEPipeline``) or video clips (``TVAEPipeline``) on an explicit
device (counterpart of ``vqgan_tpu/inference.py``).

    from vqgan_tpu_torch.inference import VAEPipeline
    pipe = VAEPipeline.from_checkpoint("vae.pt", VAEConfig(), device="cuda")
    z = pipe.encode(images)          # (B,H,W,3) uint8/float → latents (B,h,w,z)
    recon = pipe.decode(z)           # latents → float images in [0,1], numpy

    tpipe = TVAEPipeline.from_checkpoint("tvae.pt", TVAEConfig(), device="cuda")
    recon = tpipe.reconstruct(clips) # (B,T,H,W,3) uint8 → float clips in [0,1]

CLI:  python -m vqgan_tpu_torch.inference --checkpoint vae.pt --images 'a.png b.png'
      python -m vqgan_tpu_torch.inference --checkpoint tvae.pt --clips 'a.npy' \
          --vae_ch 64 [--attn_chunk 1024]
"""

from __future__ import annotations

import argparse
import os
from typing import Mapping

import numpy as np
import torch

from vqgan_tpu_torch.config import TVAEConfig, VAEConfig, parse_ch_mult
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.models.tae import TVAE
from vqgan_tpu_torch.serving_io import model_input, to_device, unit_range
from vqgan_tpu_torch.weights import load_weights


def check_reg_matches_params(cfg: VAEConfig | TVAEConfig, state_dict: Mapping) -> None:
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


def build_tvae_config(kw: Mapping, attn_chunk: int = 0) -> TVAEConfig:
    """TVAEConfig from the --vae_* arguments, as the JAX ``--clips`` CLI
    builds it: the Gaussian for "gaussian" and "identity_gaussian",
    vq_ema_decay 0 for serving."""
    reg = kw["reg_type"]
    return TVAEConfig(
        resolution=kw["vae_resolution"],
        ch=kw["vae_ch"],
        ch_mult=parse_ch_mult(kw["vae_ch_mult"]),
        num_res_blocks=kw["vae_num_res_blocks"],
        z_channels=kw["vae_z_channels"],
        reg_type="gaussian" if reg in ("gaussian", "identity_gaussian") else reg,
        vq_codebook_size=kw["vq_codebook_size"],
        vq_ema_decay=0.0,
        attn_chunk=attn_chunk,
    )


def vae_latents(model: VAE, x: torch.Tensor, *, do_clamp: bool, clamp_th: float) -> torch.Tensor:
    """The served latents of a model input x (B,H,W,C) in [-1, 1]: encode,
    clamp to ±clamp_th where ``do_clamp``, then the Gaussian mean or, for VQ,
    the nearest-code embeddings (the search and the gather only: the
    statistics the JAX package's jit drops are never computed). In the
    encoder's dtype; ``VAEPipeline.encode`` and the exported encode
    (``export.py``) both compute this."""
    z = model.encode(x)
    if do_clamp:
        z = z.clamp(-clamp_th, clamp_th)
    if model.cfg.reg_type == "gaussian":
        z = z.chunk(2, dim=-1)[0]  # mean
    elif model.cfg.reg_type == "vq":
        z = model.reg.quantize(z)
    return z


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

    def _to_model_input(self, images) -> torch.Tensor:
        return model_input(images, self.device, one_ndim=3)

    @torch.inference_mode()
    def encode(self, images) -> torch.Tensor:
        """Images (B,H,W,3) uint8 [0,255] or float [-1,1] → latents (B,h,w,z)
        on the device, clamped to ±clamp_th like the published model; for VQ
        the nearest-code embeddings (``vae_latents``)."""
        return vae_latents(self.model, self._to_model_input(images),
                           do_clamp=self.do_clamp, clamp_th=self.clamp_th)

    @torch.inference_mode()
    def decode(self, z) -> np.ndarray:
        """Latents (B,h,w,z) → float images (B,H,W,3) in [0,1], on the host."""
        return unit_range(self.model.decode(to_device(z, self.device))).cpu().numpy()

    def reconstruct(self, images) -> np.ndarray:
        return self.decode(self.encode(images))


class TVAEPipeline:
    """Serving path of the 3D video VAE (JAX ``inference.py:160-225``):
    encode to the deterministic latent (the posterior mean, or the quantized
    latent for VQ; no clamp, as in the JAX pipeline), decode, reconstruct.
    Runs under ``torch.inference_mode()`` on ``device``."""

    def __init__(self, cfg: TVAEConfig, state_dict: Mapping[str, torch.Tensor],
                 *, device: str | torch.device):
        check_reg_matches_params(cfg, state_dict)
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device(self.device):
            self.model = TVAE(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(memory_format=torch.channels_last_3d).eval()

    @classmethod
    def from_checkpoint(cls, path: str, cfg: TVAEConfig, *,
                        device: str | torch.device) -> "TVAEPipeline":
        return cls(cfg, load_weights(path), device=device)

    def _to_model_input(self, clips) -> torch.Tensor:
        return model_input(clips, self.device, one_ndim=4)

    @torch.inference_mode()
    def encode(self, clips) -> torch.Tensor:
        """Clips (B,T,H,W,3) uint8 [0,255] or float [-1,1] → latents
        (B,t,h,w,z) on the device, in the compute dtype."""
        return self.model.deterministic_latent(self.model.encode(self._to_model_input(clips)))

    @torch.inference_mode()
    def decode(self, z) -> np.ndarray:
        """Latents (B,t,h,w,z) → float clips (B,T,H,W,3) in [0,1], on the
        host."""
        return unit_range(self.model.decode(to_device(z, self.device))).cpu().numpy()

    def reconstruct(self, clips) -> np.ndarray:
        return self.decode(self.encode(clips))


def _main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m vqgan_tpu_torch.inference",
        description="Reconstruct images through a VAE checkpoint.",
    )
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--images", default="", help="space-separated image paths")
    parser.add_argument("--clips", default="",
                        help="space-separated .npy uint8 (T,H,W,3) clip paths: runs "
                             "the 3D (TVAE) pipeline instead of the 2D one")
    parser.add_argument("--attn_chunk", type=int, default=0,
                        help="clips only: chunked mid-block attention for long clips")
    parser.add_argument("--out_dir", default="./recon")
    parser.add_argument("--device", default="cuda")
    add_vae_arch_args(parser)
    args = parser.parse_args(argv)

    if bool(args.images) == bool(args.clips):
        parser.error("pass exactly one of --images / --clips")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.clips:
        tcfg = build_tvae_config(vars(args), args.attn_chunk)
        tpipe = TVAEPipeline.from_checkpoint(args.checkpoint, tcfg, device=args.device)
        for path in args.clips.split():
            clip = np.load(path)
            # a cast here would silently mangle a float or wide-int clip:
            # refuse it, as the JAX CLI does
            if clip.dtype != np.uint8:
                parser.error(f"{path}: clip dtype {clip.dtype} — --clips expects uint8 "
                             f"(T, H, W, 3) arrays in [0, 255]; convert explicitly (e.g. "
                             f"np.round(x * 255).astype(np.uint8) for floats in [0, 1])")
            if clip.ndim != 4 or clip.shape[-1] != 3:
                parser.error(f"{path}: clip shape {clip.shape} — expected (T, H, W, 3) uint8")
            recon = tpipe.reconstruct(clip)[0]
            out_path = os.path.join(
                args.out_dir, os.path.splitext(os.path.basename(path))[0] + "_recon.npy")
            np.save(out_path, (recon * 255).astype(np.uint8))
            print(f"{path} -> {out_path}")
        return
    from PIL import Image  # image files only; the pipeline needs no PIL

    cfg = build_vae_config(vars(args))
    pipe = VAEPipeline.from_checkpoint(args.checkpoint, cfg, device=args.device)
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
