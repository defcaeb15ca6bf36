"""Where the device time of the flagship training step goes, from a
torch.profiler trace (counterpart of ``tools/profile_step.py``).

    python -m vqgan_tpu_torch.tools.profile_step [--batch 8] [--steps 3] [--out DIR]
        [--reg_type identity_gaussian|vq] [--use_attn] [--attn_chunk 512]

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
kernel. TF32 on for convs, off for matmuls. Writes the chrome trace to
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


def profile_steps(batch: int, steps: int, out_dir: str | None,
                  reg_type: str = "identity_gaussian", use_attn: bool = False,
                  attn_chunk: int = 0) -> None:
    state, step, images = build_flagship_step(batch, reg_type=reg_type, use_attn=use_attn,
                                              attn_chunk=attn_chunk)
    for _ in range(2):
        state, metrics = step(state, images)
    float(metrics["overall_vae_loss"])  # waits for the device
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, images)
        float(metrics["overall_vae_loss"])
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
    what = reg_type + (" attn" if use_attn else "")
    print(f"train step {what} batch {batch}, {steps} steps: window {window_us / steps / 1e3:.3f} "
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; tf32: cudnn {torch.backends.cudnn.allow_tf32}, "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    profile_steps(args.batch, args.steps, args.out, args.reg_type, args.use_attn,
                  args.attn_chunk)


if __name__ == "__main__":
    main()
