"""Where the device time of the flagship training step, or of the 3D
step, goes, from a torch.profiler trace (counterpart of
``tools/profile_step.py``).

    python -m vqgan_tpu_torch.tools.profile_step [--batch 8] [--steps 3] [--out DIR]
        [--reg_type identity_gaussian|vq] [--use_attn] [--attn_chunk 512]
    python -m vqgan_tpu_torch.tools.profile_step --clips [--disc_3d none|frame|tubelet]
        [--batch 2] [--steps 3] [--out DIR]

Builds ``bench.py``'s flagship GAN step on the first CUDA device with random
weights from a seed: ``VAEConfig`` with bf16 encoder and decoder (ch=256,
ch_mult 1,2,4,4, 256 px), ``PatchDiscriminator`` and ``LPIPS`` computing in
bf16, hinge + LeCam + clamp. ``--reg_type vq`` swaps the identity latent for
the VQ latent at ``VAEConfig``'s defaults (K = 16,384 codes, β 0.25, EMA
0.99); ``--use_attn`` adds the mid-block AttnBlocks, on the memory-efficient
path when the 1,024 mid-block tokens exceed ``--attn_chunk``. Runs two
warm-up steps, then profiles ``--steps`` steps and prints the host-clock ms
per step, the kernels' ms per step, the device's busy and idle share of the
window (union of kernel intervals over its host-clock length), the device ms
by kernel class (GroupNorm forward and backward kernels, the VQ kernels, the
attention kernels, cuDNN convs, the AdamW updates, adds, reductions, copies
and casts, other), the top kernels, each VQ kernel and each attention
kernel. ``--clips`` profiles the 3D step instead, at ``tools/bench_tvae.py``'s
config (``build_step3d``: 16 frames x 128 px, batch ``--batch``, default 2
there): the recon-only step, or with ``--disc_3d frame|tubelet`` the GAN
step with that discriminator; the kernel classes then include kernel #6.
TF32 on for convs, off for matmuls. Writes the chrome trace to
``DIR/step_trace.json`` when ``--out`` is given. Needs a CUDA device; fails
without one.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vqgan_tpu_torch.tools.profile_serving import (
    busy_us,
    device_kernels,
    kernel_class,
    print_attention_kernels,
)

# (class, markers) for the kernels kernel_class() calls "other", in order
OTHER_CLASSES = (
    ("optimizer (AdamW, foreach)", ("multi_tensor_apply", "adam")),
    ("adds (conv bias, residual)", ("functor_add",)),
    ("reductions (conv bias grads, losses)", ("reduce_kernel",)),
    ("copies and casts", ("copy", "memcpy", "memset")),
)


def step_kernel_class(name: str) -> str:
    cls = kernel_class(name)
    if cls != "other":
        return cls
    low = name.lower()
    for label, markers in OTHER_CLASSES:
        if any(m in low for m in markers):
            return label
    return cls


def build_flagship_step(batch: int, device: str = "cuda", seed: int = 0,
                        reg_type: str = "identity_gaussian", use_attn: bool = False,
                        attn_chunk: int = 0):
    """bench.py's flagship GAN step on ``device``, with the latent
    ``reg_type`` and, with ``use_attn``, the mid-block AttnBlocks at
    ``attn_chunk``: returns (state, step, batch tensor). Weights are random:
    the reference init schemes (and the JAX package's codebook init) drawn
    from generators seeded ``seed``, ``seed + 1`` and ``seed + 2``; the batch
    is numpy's uniform [-1, 1] from ``seed``."""
    from vqgan_tpu_torch.config import TrainConfig, VAEConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.models.blocks import init_weights_
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import make_train_step

    vae_cfg = VAEConfig(enc_dtype="bfloat16", dec_dtype="bfloat16", reg_type=reg_type,
                        use_attn=use_attn, attn_chunk=attn_chunk)
    cfg = TrainConfig(batch_size=batch, image_size=vae_cfg.resolution, max_steps=10_000,
                      do_ganloss=True, disc_type="hinge", use_lecam=True, do_clamp=True)
    with torch.device(device):
        vae = VAE(vae_cfg)
        disc = PatchDiscriminator(torch.bfloat16)
        lpips = LPIPS(torch.bfloat16)
    init_weights_(vae, torch.Generator(device).manual_seed(seed))
    init_discriminator_(disc, torch.Generator(device).manual_seed(seed + 1))
    init_lpips_(lpips, torch.Generator(device).manual_seed(seed + 2))
    state = create_train_state(cfg, vae, disc, vae_cfg.ch, seed=seed)
    step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
    images = np.random.RandomState(seed).uniform(
        -1, 1, (batch, vae_cfg.resolution, vae_cfg.resolution, 3)).astype(np.float32)
    return state, step, torch.from_numpy(images).to(device)


def build_step3d(batch: int = 2, frames: int = 16, res: int = 128, disc_3d: str = "none",
                 device: str = "cuda", learning_rate_vae: float | None = None):
    """The 3D step at ``tools/bench_tvae.py``'s config (ch 64, ch_mult 1,2,4,
    1 res block, z 8, bf16, gaussian) on ``device``: the recon-only step
    (``disc_3d="none"``), or the GAN step (hinge + LeCam, 4 of the frames to
    LPIPS and D, fp32 LPIPS and D as the JAX 3D trainer builds them) with
    the frame or tubelet discriminator. Random weights from seeds 0-2;
    ``learning_rate_vae`` overrides TrainConfig's. Returns (state, step,
    model, D or None, a clip batch source from ``synthetic_video_batches``
    yielding device tensors)."""
    import dataclasses

    from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
    from vqgan_tpu_torch.losses.discriminator import (
        PatchDiscriminator,
        TubeletDiscriminator,
        init_discriminator_,
    )
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.tae import init_tvae
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step3d import make_train_step_3d, make_train_step_3d_gan
    from vqgan_tpu_torch.train.trainer3d import synthetic_video_batches

    tvae_cfg = TVAEConfig(resolution=res, ch=64, ch_mult=(1, 2, 4), num_res_blocks=1,
                          z_channels=8, compute_dtype="bfloat16")
    model = init_tvae(tvae_cfg, torch.Generator().manual_seed(0)).to(device)
    src = (torch.from_numpy(c).to(device)
           for c in synthetic_video_batches(batch, frames, res, seed=0))
    cfg = TrainConfig(batch_size=batch)
    if learning_rate_vae is not None:
        cfg = dataclasses.replace(cfg, learning_rate_vae=learning_rate_vae)
    if disc_3d == "none":
        state = create_train_state(cfg, model, None, tvae_cfg.ch, recon_only=True)
        return state, make_train_step_3d(cfg, tvae_cfg, model), model, None, src
    loss_frames = min(4, frames)
    cfg = dataclasses.replace(cfg, do_ganloss=True, disc_type="hinge", use_lecam=True,
                              video_loss_frames=loss_frames, disc_3d=disc_3d)
    with torch.device(device):
        disc = (TubeletDiscriminator(loss_frames) if disc_3d == "tubelet"
                else PatchDiscriminator())
        lpips = LPIPS()
    init_discriminator_(disc, torch.Generator(device).manual_seed(1))
    init_lpips_(lpips, torch.Generator(device).manual_seed(2))
    state = create_train_state(cfg, model, disc, tvae_cfg.ch)
    return state, make_train_step_3d_gan(cfg, tvae_cfg, model, disc, lpips), model, disc, src


def profile_steps(state, step, batches, steps: int, out_dir: str | None, what: str,
                  loss_key: str, unit: str) -> None:
    """Two warm-up steps, then ``steps`` profiled ones, each on the next of
    ``batches``; prints the breakdown (``unit``: what a step's batch holds)."""
    for _ in range(2):
        state, metrics = step(state, next(batches))
    float(metrics[loss_key])  # waits for the device
    inputs = [next(batches) for _ in range(steps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs:
            state, metrics = step(state, x)
        float(metrics[loss_key])
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    by_class: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.elapsed_us()
        cls = step_kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += dur
        entry[1] += 1
    total = sum(by_class.values())
    busy = busy_us(kernels)
    print(f"train step {what} ({unit}), {steps} steps: window {window_us / steps / 1e3:.3f} "
          f"ms/step host clock, kernels {total / steps / 1e3:.3f} ms/step, device busy "
          f"{busy / window_us:.4f} of the window (idle {1 - busy / window_us:.4f})")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {us / steps / 1e3:.3f} ms/step ({us / total:.4f} of kernel time)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print("top kernels by device time:")
    for name, (us, n) in ranked[:20]:
        print(f"  {us / steps / 1e3:8.3f} ms/step  {n // steps:4d} calls/step  {name[:110]}")
    vq = [(name, v) for name, v in ranked if step_kernel_class(name).startswith("VQ")]
    if vq:
        print("VQ kernels:")
        for name, (us, n) in vq:
            print(f"  {us / steps / 1e3:8.4f} ms/step  {n // steps:4d} calls/step  {name[:110]}")
    print_attention_kernels(ranked, steps, "step")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "step_trace.json"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--reg_type", default="identity_gaussian",
                        choices=("identity_gaussian", "vq"))
    parser.add_argument("--use_attn", action="store_true")
    parser.add_argument("--attn_chunk", type=int, default=512)
    parser.add_argument("--clips", action="store_true",
                        help="profile the 3D step at tools/bench_tvae.py's config")
    parser.add_argument("--disc_3d", default="none", choices=("none", "frame", "tubelet"),
                        help="with --clips: the recon-only step, or the GAN step with this D")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; tf32: cudnn {torch.backends.cudnn.allow_tf32}, "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    if args.clips:
        batch = 2 if args.batch == parser.get_default("batch") else args.batch
        state, step, _, _, batches = build_step3d(batch, disc_3d=args.disc_3d)
        what = "3D recon-only" if args.disc_3d == "none" else f"3D GAN {args.disc_3d}"
        profile_steps(state, step, batches, args.steps, args.out, what,
                      "loss" if args.disc_3d == "none" else "overall_vae_loss",
                      f"batch {batch} of 16 frames x 128 px")
        return
    state, step, images = build_flagship_step(args.batch, reg_type=args.reg_type,
                                              use_attn=args.use_attn,
                                              attn_chunk=args.attn_chunk)
    what = args.reg_type + (" attn" if args.use_attn else "")
    profile_steps(state, step, iter(lambda: images, None), args.steps, args.out, what,
                  "overall_vae_loss", f"batch {args.batch}")


if __name__ == "__main__":
    main()
