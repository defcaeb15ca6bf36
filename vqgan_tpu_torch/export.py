"""Serving export: ``torch.export`` artifacts of the 2D VAE and the 3D TVAE
(counterpart of ``vqgan_tpu/export.py``).

An artifact is a directory of two exported programs, ``encode.pt2`` and
``decode.pt2``, with the weights inside, and a ``manifest.json``: a serving
process loads and calls it with no model definition, no config plumbing and
no model code of this package (``ExportedVAE.load`` imports the operators of
``ops/custom_ops.py`` and torch, nothing else of the port).

    from vqgan_tpu_torch.export import export_vae, ExportedVAE
    export_vae(cfg, state_dict, "artifact/")       # traced on the card
    vae = ExportedVAE.load("artifact/")            # anywhere, any process
    z = vae.encode(images)                         # (B,H,W,3) uint8/float -> latents
    recon = vae.decode(z)                          # latents -> float images in [0,1]

Semantics match ``inference.VAEPipeline`` and ``TVAEPipeline``: encode clamps
to ±clamp_th (the 2D VAE) and returns the Gaussian mean, or the nearest-code
embeddings for VQ, as float32 on the artifact's device; decode maps to [0, 1]
and returns a float32 host array. The batch is one symbolic dimension, so one
artifact serves any batch size; resolution (and the clip length) are static.

Where it runs: the graph calls the three serving kernels through operators
(GroupNorm #1, attention #3's forward, the VQ search #4) that the dispatcher
sends to the hand kernel on a CUDA tensor and to the plain version on a CPU
tensor. So an artifact traced on the card launches the kernels there and
still loads and runs on the CPU (``load(dir, device="cpu")``), and one traced
on the CPU launches them when loaded onto the card: the portability of the
JAX artifact's ``("cpu", "tpu")`` lowering, with the kernels kept. A device
other than the tracing one goes through ``torch.export``'s
``move_to_device_pass``.

CLI: ``python -m vqgan_tpu_torch.export --checkpoint vae.pt --out_dir artifact/``
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn as nn
from torch.export.passes import move_to_device_pass

from vqgan_tpu_torch.config import TVAEConfig
# the operators the exported graphs call: registered before any program loads
from vqgan_tpu_torch.ops import custom_ops  # noqa: F401
from vqgan_tpu_torch.serving_io import model_input, to_device, unit_range

_MANIFEST = "manifest.json"
_ENCODE = "encode.pt2"
_DECODE = "decode.pt2"
# the batch of the example inputs: above 1, so the trace cannot specialise
# the symbolic batch to a batch of one
_TRACE_BATCH = 2


def _device(device: str | torch.device) -> torch.device:
    """``device`` with a CUDA index filled in; raises for a CUDA device
    where there is none (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() "
                               f"is False")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


class _Served(nn.Module):
    """One serving function ``fn(model, x)`` of a pipeline's model, as the
    module ``torch.export`` traces."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.model, x)


def _write(out_dir: str, model: nn.Module, encode_fn: Callable, decode_fn: Callable,
           x_shape: tuple, z_shape: tuple, manifest: dict) -> None:
    """Trace encode and decode with a symbolic batch and write the artifact."""
    device = next(model.parameters()).device
    model.requires_grad_(False)
    batch = torch.export.Dim("b", min=1)
    programs = {}
    for name, fn, shape in ((_ENCODE, encode_fn, x_shape), (_DECODE, decode_fn, z_shape)):
        example = torch.zeros((_TRACE_BATCH, *shape), dtype=torch.float32, device=device)
        with torch.no_grad():
            programs[name] = torch.export.export(_Served(model, fn), (example,),
                                                 dynamic_shapes=({0: batch},))
    os.makedirs(out_dir, exist_ok=True)
    for name, program in programs.items():
        with warnings.catch_warnings():
            # every weight is a storage of its own; the archive calls a
            # channels-last one "not complete" and writes it whole, as it should
            warnings.filterwarnings("ignore", message="No complete tensor found")
            torch.export.save(program, os.path.join(out_dir, name))
    manifest = {**manifest, "torch_version": torch.__version__, "device": str(device)}
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def export_vae(
    cfg,
    state_dict: Mapping[str, torch.Tensor],
    out_dir: str,
    *,
    do_clamp: bool = True,
    clamp_th: float = 8.0,
    device: str | torch.device = "cuda",
) -> None:
    """Write a self-contained serving artifact for ``VAE(cfg)`` with the
    weights ``state_dict`` (reference key names, ``weights.load_weights``),
    traced on ``device``.

    The batch dimension is symbolic; the spatial dimensions are static at
    ``cfg.resolution`` (export one artifact per serving resolution).

    VQ models: encode bakes in the nearest-code search (kernel #4 on the
    card) and returns the quantized embeddings. There is no ``vq_ema``
    argument: the port's modules declare no EMA statistics, and serving reads
    the codebook from the state dict (``reg.codebook``), which is what the
    JAX artifact serves too.

    ``cfg.use_pallas_gn`` is accepted: the JAX export refuses it because a
    Pallas call would make its artifact TPU-only, but here the flag has no
    effect, and the GroupNorm operator runs on the card and on the CPU alike.
    ``upsample_impl`` is pinned to "direct", as in the JAX export; here every
    value computes that form anyway.
    """
    from vqgan_tpu_torch.inference import VAEPipeline, vae_latents

    cfg = dataclasses.replace(cfg, upsample_impl="direct")
    pipe = VAEPipeline(cfg, state_dict, device=_device(device), do_clamp=do_clamp,
                       clamp_th=clamp_th)
    res = cfg.resolution
    latent_res = res // cfg.ffactor
    out_res = res * (2 if cfg.decoder_also_perform_hr else 1)
    _write(
        out_dir, pipe.model,
        lambda m, x: vae_latents(m, x, do_clamp=do_clamp, clamp_th=clamp_th).float(),
        lambda m, z: unit_range(m.decode(z)),
        (res, res, cfg.in_channels), (latent_res, latent_res, cfg.z_channels),
        {
            "format": ExportedVAE._FORMAT,
            "vae_config": dataclasses.asdict(cfg),
            "reg_type": cfg.reg_type,
            "do_clamp": do_clamp,
            "clamp_th": clamp_th,
            "encode_input": ["b", res, res, cfg.in_channels],
            "encode_output": ["b", latent_res, latent_res, cfg.z_channels],
            "decode_input": ["b", latent_res, latent_res, cfg.z_channels],
            "decode_output": ["b", out_res, out_res, cfg.out_ch],
            "io_dtype": "float32",
            "image_range_in": "[-1, 1] (uint8 accepted by ExportedVAE.encode)",
            "image_range_out": "[0, 1]",
        })


def export_tvae(
    cfg,
    state_dict: Mapping[str, torch.Tensor],
    out_dir: str,
    *,
    frames: int,
    device: str | torch.device = "cuda",
) -> None:
    """Write a serving artifact for the 3D video VAE (``TVAE(cfg)``), traced
    on ``device``.

    The batch is symbolic; the clip length ``frames`` and the resolution are
    static (stride-2 Conv3d shapes depend on both: export one artifact per
    serving clip geometry). Encode returns the posterior mean (gaussian) or
    the quantized embeddings (vq); decode maps to [0, 1].

    ``conv3d_impl`` and ``upsample_impl`` are pinned to "direct", as the JAX
    export pins them: every Conv3d of the artifact is ``F.conv3d`` (cuDNN on
    the card), so kernel #6 is not in it. Attention needs no rewrite: its
    operator is portable by construction. No ``vq_ema`` argument, as in
    ``export_vae``.
    """
    from vqgan_tpu_torch.inference import TVAEPipeline

    if not isinstance(cfg, TVAEConfig):
        raise TypeError(f"export_tvae takes a TVAEConfig, got {type(cfg).__name__}")
    cfg = dataclasses.replace(cfg, conv3d_impl="direct", upsample_impl="direct")
    res = cfg.resolution
    f = 2 ** (len(cfg.ch_mult) - 1)
    if frames % f or res % f:
        raise ValueError(
            f"frames {frames} and resolution {res} must divide the "
            f"spatio-temporal factor {f} (2^(len(ch_mult)-1))"
        )
    pipe = TVAEPipeline(cfg, state_dict, device=_device(device))
    t_lat, s_lat = frames // f, res // f
    _write(
        out_dir, pipe.model,
        lambda m, x: m.deterministic_latent(m.encode(x)).float(),
        lambda m, z: unit_range(m.decode(z)),
        (frames, res, res, cfg.in_channels), (t_lat, s_lat, s_lat, cfg.z_channels),
        {
            "format": ExportedTVAE._FORMAT,
            "tvae_config": dataclasses.asdict(cfg),
            "reg_type": cfg.reg_type,
            "encode_input": ["b", frames, res, res, cfg.in_channels],
            "encode_output": ["b", t_lat, s_lat, s_lat, cfg.z_channels],
            "decode_input": ["b", t_lat, s_lat, s_lat, cfg.z_channels],
            "decode_output": ["b", frames, res, res, cfg.out_ch],
            "io_dtype": "float32",
            "image_range_in": "[-1, 1] (uint8 accepted by ExportedTVAE.encode)",
            "image_range_out": "[0, 1]",
        })


class _ExportedArtifact:
    """Shared loader and caller of export artifacts; subclasses pin the
    manifest format and the dimensions of one input item."""

    _FORMAT = ""
    _ITEM_NDIM = 0

    def __init__(self, manifest: dict, enc: nn.Module, dec: nn.Module, device: torch.device):
        self.manifest = manifest
        self.device = device
        self._enc = enc
        self._dec = dec

    @classmethod
    def load(cls, artifact_dir: str, device: str | torch.device | None = None):
        """The artifact in ``artifact_dir``, on the device it was traced on,
        or on ``device`` (moved by ``move_to_device_pass``)."""
        with open(os.path.join(artifact_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != cls._FORMAT:
            raise ValueError(f"unrecognized artifact format: {manifest.get('format')}")
        traced = torch.device(manifest["device"])
        device = _device(traced if device is None else device)
        modules = []
        for name in (_ENCODE, _DECODE):
            program = torch.export.load(os.path.join(artifact_dir, name))
            if device != traced:
                program = move_to_device_pass(program, device)
            modules.append(program.module())
        return cls(manifest, *modules, device)

    @torch.inference_mode()
    def encode(self, x) -> torch.Tensor:
        """uint8 [0,255] or float [-1,1] inputs → float32 latents on the
        artifact's device."""
        return self._enc(model_input(x, self.device, self._ITEM_NDIM))

    @torch.inference_mode()
    def decode(self, z) -> np.ndarray:
        """Latents → float32 outputs in [0,1], on the host."""
        return self._dec(to_device(z, self.device).float()).cpu().numpy()

    def reconstruct(self, x) -> np.ndarray:
        return self.decode(self.encode(x))


class ExportedVAE(_ExportedArtifact):
    """Loads and calls an ``export_vae`` artifact, no model code needed.
    encode takes images (B,H,W,3) or one (H,W,3)."""

    _FORMAT = "vqgan_tpu_torch.export/v1"
    _ITEM_NDIM = 3


class ExportedTVAE(_ExportedArtifact):
    """Loads and calls an ``export_tvae`` artifact, no model code needed.
    encode takes clips (B,T,H,W,3) or one (T,H,W,3)."""

    _FORMAT = "vqgan_tpu_torch.export/v1-video"
    _ITEM_NDIM = 4


def _load_export_weights(checkpoint: str) -> dict[str, torch.Tensor]:
    """A reference-format ``.pt``, or a port trainer's run directory
    (``<ckpt_dir>/<run_name>``, or its ``state/`` directory of full-state
    checkpoints): the latest step's state, taken down to the generator's
    parameters (``g_model``)."""
    from vqgan_tpu_torch.weights import load_weights

    if not os.path.isdir(checkpoint):
        return load_weights(checkpoint)
    from vqgan_tpu_torch.train.checkpoint import CheckpointManager

    directory = checkpoint
    if os.path.isdir(os.path.join(directory, "state")):
        directory = os.path.join(directory, "state")
    tree = CheckpointManager(directory).read()
    if tree is None:
        raise FileNotFoundError(f"no step_*.pt checkpoint in {directory}")
    return tree["g_model"]


def _main(argv: list[str] | None = None) -> None:
    from vqgan_tpu_torch.inference import (
        _bool,
        add_vae_arch_args,
        build_tvae_config,
        build_vae_config,
    )

    parser = argparse.ArgumentParser(
        prog="python -m vqgan_tpu_torch.export",
        description="Write a torch.export serving artifact of a VAE or TVAE checkpoint.",
    )
    parser.add_argument("--checkpoint", required=True,
                        help="reference-format .pt, or a trainer's run directory")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--family", type=str, default="vae", help="vae (2D image) | tvae (3D video)")
    parser.add_argument("--frames", type=int, default=16,
                        help="clip length for --family tvae (static in the artifact)")
    parser.add_argument("--attn_chunk", type=int, default=0,
                        help="tvae only: chunked mid-block attention, like the train3d "
                             "flag — required to serve long-clip models whose dense score "
                             "matrix exceeds accelerator memory")
    parser.add_argument("--do_clamp", type=_bool, default=True)
    parser.add_argument("--clamp_th", type=float, default=8.0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to trace on, where ExportedVAE.load runs the "
                             "artifact by default. Takes the place of the JAX export's "
                             "--platforms: one artifact runs on the card and on the CPU, "
                             "since its kernels are operators that the dispatcher sends to "
                             "the hand kernel or the plain version by device")
    add_vae_arch_args(parser)
    args = parser.parse_args(argv)
    kw = vars(args)
    state_dict = _load_export_weights(args.checkpoint)
    if args.family == "tvae":
        export_tvae(build_tvae_config(kw, args.attn_chunk), state_dict, args.out_dir,
                    frames=args.frames, device=args.device)
    elif args.family == "vae":
        export_vae(build_vae_config(kw), state_dict, args.out_dir, do_clamp=args.do_clamp,
                   clamp_th=args.clamp_th, device=args.device)
    else:
        parser.error(f"unknown --family {args.family}")
    print(f"Exported serving artifact to {args.out_dir}")


if __name__ == "__main__":
    _main()
