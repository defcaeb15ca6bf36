#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vqgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the TF32 flags;
  2. build every kernel from ``vqgan_tpu_torch/csrc/``;
  3. the forward kernel (#1: one launch of thread-block clusters a call)
     against its plain PyTorch version at every GroupNorm shape of a
     flagship reconstruct and at C = 96 and 192 (a width-96 VAE's top
     levels), batch 2 and batch 8, fp32 and bf16, swish on and off: max abs
     error against the stated tolerance, two calls bitwise equal (y and
     stats), one launch a call, the kernel faster than plain; kernel, plain
     and library times, each the device's (CUDA graph replays), the bound,
     the share of it the kernel reaches and the plan (units, slice, cluster,
     held packs) on each line; the per-step sum against the bound and
     GN_FWD_TARGET_MS at the end (and the same checks at the 3D steps' 5-D
     shapes after phase 24);
  4. the backward kernel (#2: one cooperative launch a call) against its
     plain version at the same shapes, batch 8, fp32 and bf16, swish on and
     off: dx, dγ, dβ against the stated tolerances, two calls bitwise equal,
     one launch a call, the kernel faster than plain; kernel, plain and
     library times, each the device's (CUDA graph replays), the bound and
     the plan (units, slice width, teams, grid, route) on each line; the
     per-step sum against the bound and GN_BWD_TARGET_MS at the end (and the
     same checks at the 3D steps' 5-D shapes after phase 24);
  5. the serving path at the flagship config (``VAEConfig()``: ch=256,
     ch_mult 1,2,4,4, 256 px), random weights from a seed, written as a
     reference-format .pt and served through ``VAEPipeline.from_checkpoint``:
     shapes, finiteness, ranges, exactly 21 kernel launches per encode and 29
     per decode, img/s and peak memory at batch 8;
  6. the flagship training step (``bench.py``'s config: bf16 encoder and
     decoder, bf16 LPIPS and PatchDiscriminator, hinge + LeCam + clamp) at
     batch 8 through ``create_train_state`` and ``make_train_step``: D moves
     in step 1 and G in step 2 (its lr is 0 at step 0), exactly 50 forward
     and 50 backward kernel launches per step and how many incoming
     GroupNorm gradients needed a copy to channels_last, finite metrics,
     img/s and ms per step by the host clock, ms per step between CUDA
     events on the stream over the same 5 steps, peak memory;
  7. serving: the same weights and images on the CPU (plain GroupNorm) and on
     the card (kernels) at a reduced width, TF32 off;
  8. training: one step on the CPU and on the card from the same weights,
     batch and draws at a reduced width, fp32, TF32 off: losses, and the
     gradients read from AdamW's first moments, with the loss head's
     discrete decisions (the ReLU masks and max-pool argmaxes of LPIPS's and
     D's VGG16 towers and D's heads) recorded on the CPU and replayed on the
     card (``DecisionTape``), so that the comparison sees rounding alone; the
     card's step without the replay too, its losses within the same bounds
     and its gradients' share printed;
  9. the VQ nearest-code search kernel against its plain version at the
     flagship shapes (N = 8192 and 2048 tokens, K = 16384 codes, D = 16),
     a ragged N, several K tiles, a K of 32 and a codebook with every code
     duplicated (the first copy must win): codes compared by distance in
     fp64; kernel, plain and library (cuBLAS addmm + argmin) times and the
     bound. The code-statistics kernel at the same shapes, counts only and
     with sums: counts exact, sums within a bound of Σ|terms|;
 10. VQ serving at the flagship width (``VAEConfig(reg_type="vq")``), random
     weights with a codebook, from a reference-format .pt: every latent a
     codebook row, 1 search launch per encode, 50 GroupNorm launches per
     reconstruct, img/s and peak memory at batch 8;
 11. the flagship VQ training step (phase 6's, with ``reg_type="vq"``, K =
     16384, EMA 0.99) at batch 8: 1 search and 1 statistics launch per step
     beside the 50 + 50 GroupNorm launches, the EMA counts move and the
     codebook is folded in step 1, finite metrics with ``vq_loss``, img/s,
     step ms (host clock and CUDA events, as in phase 6) and peak memory;
 12. VQ, CPU against card at the reduced width of phases 7-8 with K = 1024:
     serving latents by distance; one training step (EMA 0.9, revival at
     0.5, the same draws and revival rows): losses and gradients within
     phase 8's bounds, EMA counts, the folded codebook;
 13. the attention kernels (forward; backward: delta, dK/dV, dQ) against
     their plain versions on q/k/v views of one qkv tensor, fp32 and bf16: at
     the flagship mid block (B = 8, N = 1,024, H = 16, D = 64), forward and
     backward; the high-resolution mid block (B = 1, N = 16,384), forward;
     D = 32 (B = 1, N = 4,096, H = 8), D = 16 (B = 2, N = 4,096, H = 8), D =
     128 (B = 1, N = 4,096, H = 8) and a ragged N = 400, forward and
     backward; the long clip's mid block (B = 1, N = 49,152, H = 8, D = 32),
     forward. Every call counted on its route (bf16 the tensor cores, fp32
     FMA); out, lse, dq, dk, dv within their stated bounds; two runs of the
     bf16 backward bitwise equal; kernel, plain and library
     (``F.scaled_dot_product_attention``, forward, and its backward through
     autograd: forward + backward less forward) times, each the device's
     (CUDA graph replays), the wrapper's CUDA-event time beside the kernel's,
     TFLOP/s, the ratio to the library and the bound (operations, exps at
     the SFU's rate, or bytes). Fails where a bf16 call is slower than its
     plain version;
 14. flagship serving with the mid-block attention (``VAEConfig(use_attn=
     True, attn_chunk=512)``), from a reference-format .pt: 22 GroupNorm and
     1 attention launch per encode, 30 and 1 per decode, img/s and peak
     memory at batch 8; the fp32 encoder's call on the FMA route, the bf16
     decoder's on the tensor cores;
 15. the same weights at 1,024 px, batch 1, ``attn_chunk=1024`` (16,384
     mid-block tokens): finite output in range, the routes as in 14, img/s
     and peak memory;
 16. the flagship training step with attention at batch 8: 52 + 52
     GroupNorm and 2 + 2 attention launches per step, all four on the
     tensor cores (bf16 encoder and decoder), D moves in step 1 and
     G in step 2, finite metrics, img/s, step ms and peak memory;
 17. attention, CPU against card at the reduced width of phases 7-8 (mid
     block 256 tokens, 4 heads of 64, ``attn_chunk=128``): serving, and one
     training step within phase 8's bounds;
 18. the fused-tap Conv3d kernel (#6), both routes, against its plain
     version, forward and dx (the same kernel on the flipped, transposed
     weight): bf16 on the tensor cores at every distinct conv shape of a
     16-frame 128 px TVAE reconstruct at batch 2, of the 48-frame 256 px
     long clip at batch 1 and of the 3D training config (phases 23-24), and
     at the edge cases (T = 1, Ci = Co = 3, ragged H/W, Ci not a multiple of
     8 or 16), there also the fp32 sums before the cast against the fp32
     plain version of the same bf16 inputs (the tensor cores' accumulation
     alone); fp32 on the CUDA cores at the fp32 and edge cases; every call
     counted on its route. dx and dk through the autograd Function at two
     shapes. Every output within ``ops/conv3d.py::bound_share``'s bound
     (``rounding_bound`` plus one bf16 ulp); at each shape the plan's tile
     and splits, kernel ms and TFLOP/s, plain, library (``F.conv3d`` and
     cuDNN's dgrad in bf16, channels_last_3d) and bound times, each the
     device's (CUDA graph replays); where the launch plan splits K, the
     same call at one split too. Fails where the kernel is slower than
     its plain version, or the split plan than one split, at a bf16 path
     shape;
 19. TVAE clip serving (``TVAEConfig()``: ch=64, ch_mult 1,2,4,4, 2 res
     blocks, z=16, bf16; 16 frames x 128 px, batch 2), random weights from a
     seed, from a reference-format .pt: latents (2, 2, 16, 16, 16) finite,
     output in [0, 1], exactly 22 Conv3d and 22 GroupNorm launches per
     encode and 33 and 30 per decode at the stated shapes, every Conv3d
     call on the tensor-core route; the GroupNorm
     kernel (#1) held against its plain version at every (B, C, T, H, W)
     the reconstruct ran (5-D channels_last_3d, bf16, no swish); frames/s
     and peak memory; the same .pt with ``conv3d_impl="direct"`` (cuDNN)
     timed as a yardstick; then the gradient of a reconstruct loss through the model
     (the 3D training slice's path): 54 dx and 52 GroupNorm backward
     launches, finite gradients;
 20. long-clip serving (48 frames x 256 px, batch 1, ch_mult 1,2,4,
     ``attn_chunk=1024``; 49,152 mid-block tokens, 8 heads of 32): 1 + 1
     attention launches (both on the tensor-core route), 18 + 26 Conv3d
     launches (all on the tensor cores), finite output in range;
     the GroupNorm kernel against its plain version at every shape of the
     reconstruct, as in phase 19; frames/s and peak memory;
 21. TVAE serving, CPU against card, at ch=32, ch_mult 1,8 and 1,4 (mid-block
     head_dim 32 and 16), 1 res block,
     4 frames x 32 px, ``attn_chunk=64`` (512 mid-block tokens of 256
     channels: kernels #6, #1 and #3), fp32 with TF32 off and bf16;
 22. the conv-tile geometry probe (kernel #7): its entry point
     (``vqgan_tpu_torch.tools.probe_conv3d_geometry.run_probe``) builds and
     launches all eight cases A-H once (8 counted launches), each built and
     within the JAX tool's rtol = atol = 2e-2 of its plain version; then each
     case's grid (blocks, clusters of a K split), registers and local bytes,
     kernel, plain and ``torch.matmul`` (the same product) times by the
     device (CUDA graph replays of 100 calls) beside the host clock's, and
     its bound;
 23. the 3D recon-only step (``make_train_step_3d``) at ``tools/bench_tvae.py``'s
     config (ch 64, ch_mult 1,2,4, 1 res block, z 8, bf16, gaussian, 16
     frames x 128 px, batch 2, clips from ``synthetic_video_batches``): the
     loss falls over 5 steps, exactly 32 kernel #6 forward, 31 dx (all on
     the tensor cores), 30 + 30 GroupNorm launches per step (the wrappers'
     counts and the model's hooks), finite metrics, frames/s, ms per step
     and peak memory;
 24. the 3D GAN step (``make_train_step_3d_gan``: hinge + LeCam, 4 of 16
     frames to LPIPS and D) at the same config, with ``disc_3d="frame"`` and
     ``"tubelet"``: D moves in step 1 and G in step 2, the same exact
     launches, finite metrics, frames/s, ms per step and peak memory; then
     kernels #1 and #2 against their plain versions, as in phases 3 and 4,
     at every 5-D GroupNorm shape the steps ran (recorded by forward hooks);
 25. the 3D GAN step, CPU against card, at phase 21's configs (kernels #6
     forward and dx, #1/#2 on 5-D input, #3 forward and backward at head
     dim 32 or 16), gaussian + frame D and VQ (K = 1024, EMA, revival) +
     tubelet D at ch_mult 1,8, gaussian + frame D at 1,4: losses and
     gradients within phase 8's bounds with the loss head's decisions
     replayed, as in phase 8, EMA counts to one token;
 26. the training job through its entry point, ``vqgan_tpu_torch.cli.main``,
     at the flagship width (``TRAIN_JOB``: ch 256, ch_mult 1,2,4,4, 2 res
     blocks, z 16, 256 px, batch 8 from 512 px synthetic images, the
     sampled Gaussian latent, hinge GAN + LeCam, all bf16, 6 steps, eval
     every 3): every parameter, optimizer moment and batch on the card;
     exactly 6 x (50 + 50) GroupNorm launches plus 50 forward launches for
     each of the 2 evals (after steps 1 and 4); every logged loss finite;
     each eval line with eval/lpips, eval/rfid_vgg_proxy, eval/psnr and
     eval/ssim, finite, SSIM in [-1, 1], no eval/metrics_failed; the raw .pt
     and the full checkpoint written, the .pt served by ``VAEPipeline``
     (2 images, finite, in [0, 1]); then a second call with ``--max_steps
     8`` restores step 6, every tensor of the state and the generator's
     state bitwise those the first call ended with (and saved) right after
     the restore, and runs 2 more steps (2 x (50 + 50) + 50 launches) with
     finite losses; ms per step by the host clock with CUDA events beside
     it, the job's wall time a step and its wait for the batch from the
     JSONL, eval and save seconds, peak memory, the seconds of phases 26-27;
 27. the same job with ``--reg_type vq`` for 3 steps (K = 16,384, EMA 0.99):
     1 search and 1 statistics launch a step, 1 search more for the eval
     after step 1; a third Trainer restores its last checkpoint and gets back
     the state the job ended with, ``vq_ema`` included, bitwise.

The kernels are built in parallel, one nvcc per source. The second-to-last
line is a JSON summary of the kernels; the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits 1 and prints neither.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SERVE_BATCH = 8
TRAIN_BATCH = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # H100 SXM, bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12  # H100 SXM, TF32 tensor cores, dense
# exps a clock per SM for compute capability 9.0 (CUDA C Programming Guide,
# arithmetic instruction throughput: base-2 exponential on the SFU)
SFU_EXPS_PER_CLOCK_SM = 16
# (S = H*W, C) -> calls per reconstruct, from the flagship config
ENCODER_GN_SHAPES = {  # fp32
    (65536, 256): 4, (16384, 256): 1, (16384, 512): 3, (4096, 512): 1,
    (4096, 1024): 3, (1024, 1024): 9,
}
DECODER_GN_SHAPES = {  # bf16
    (1024, 1024): 10, (4096, 1024): 6, (16384, 1024): 1, (16384, 512): 5,
    (65536, 512): 1, (65536, 256): 6,
}
# kernel vs plain: fp32 differs only in the statistics' summation order, a
# few ulps of |y| < 16; bf16 outputs may straddle a rounding boundary, one
# bf16 ulp = at most 2^-7 of the value
ATOL_FP32 = 1e-5
RTOL_BF16 = 2.0 ** -7
# whole path, CPU vs card, TF32 off: fp32 convs sum in other orders through
# 10 ResnetBlocks. A bf16 decoder rounds each conv output on either device;
# the CPU's bf16 decoder is 0.0033 mean and 0.033 max from its fp32 decoder
# at this config, so two bf16 decoders may differ by twice that
ATOL_PATH_FP32 = 1e-3
MEAN_TOL_PATH_BF16 = 0.01
MAX_TOL_PATH_BF16 = 0.1
# backward kernel vs plain. dx: fp32 terms of size O(1) whose coefficients
# come from sums taken in another order differ by a few ulps before any
# rounding to bf16; bf16 dx then one bf16 ulp (rtol 2^-7). dγ, dβ: sums over
# B·H·W terms in another order; a fixed-order fp32 sum of n terms is off by
# about √n·eps of Σ|terms|, the kernel's chains are a few hundred adds long:
# 1e-5 of Σ|terms| leaves a wide margin
ATOL_DX = 1e-5
SUM_RTOL = 1e-5
# kernel #2's device time per flagship training step (50 bf16 calls with the
# swish at batch 8): at most half its bound's speed, 2 x 5.003 ms
GN_BWD_TARGET_MS = 10.0
# kernel #1's: 0.61 of its 3.335 ms bound (PERF.md, Findings)
GN_FWD_TARGET_MS = 5.5
# (S, C) of GroupNorms off the flagship: the top levels of a VAE of width 96
# (slices of whole groups that are no power of two of 16-byte packs)
ODD_GN_SHAPES = [(65536, 96), (16384, 192)]
# training step, CPU vs card, fp32, TF32 off. Losses: the repo's bound for a
# loss against another implementation (tests/test_full_step_parity.py:199);
# the discriminator's accuracy counts logits > 0, so one logit on either side
# of 0 moves it by 1/count. Gradients: per tensor, relative to its largest
# entry; the VGG towers' ReLUs (and the hinge) pass or stop gradient where a
# pre-activation lies within rounding noise of 0 (tests/test_torch_train_step.py
# measured 2.2e-3 for G and 4.8e-3 for D against the JAX step)
LOSS_RTOL, LOSS_ATOL = 8e-3, 8e-4
GRAD_RTOL = 1e-2
GRAD_FLOOR = 1e-6  # of the largest gradient entry
# VQ search, kernel vs plain: each computes a distance from a D-term fp32 dot
# product, ‖E‖² and (the plain one) ‖z‖², in other orders; each distance is
# off by at most (D + 2)·u·(‖z‖² + 2|z·E| + ‖E‖²), u = 2^-24, with
# 2|z·E| <= ‖z‖² + ‖E‖². Where the two pick different codes, the kernel's is
# at most both errors farther from z (fp64 distances): this factor of u
VQ_GAP_U = 2.0 ** -24
# VQ statistics: counts are exact; a code's sum of m rows in another order is
# off by at most 2·(m − 1)·u of Σ|terms|.
# (N, K, D) of the VQ cases; the flagship latent is 32x32x16 per image
VQ_CASES = {
    "flagship b8": (8192, 16384, 16), "flagship b2": (2048, 16384, 16),
    "ragged N": (700, 256, 16), "K tiles": (512, 2048, 8), "small K": (64, 32, 4),
}
VQ_CROSS_K = 1024
# attention: the flagship's attn_chunk (its mid block has 1,024 tokens) and
# the high-resolution serving's (16,384 tokens)
ATTN_CHUNK = 512
HIRES_CHUNK = 1024
# kernel #3 cases: name -> (B, N, H, D, the plain version's chunk, backward)
ATTN_CASES = {
    "flagship": (8, 1024, 16, 64, ATTN_CHUNK, True),
    "high-res": (1, 16384, 16, 64, HIRES_CHUNK, False),
    "head_dim 32": (1, 4096, 8, 32, 1024, True),
    "ragged N": (2, 400, 4, 64, 400, True),
    "long clip": (1, 49152, 8, 32, 1024, False),  # the 48f/256px TVAE's mid block
    # the TVAE's 8 heads of C/8: ch=32 at ch_mult (1, 4), and ch=256
    "head_dim 16": (2, 4096, 8, 16, 1024, True),
    "head_dim 128": (1, 4096, 8, 128, 1024, True),
}
# kernel vs plain on the same inputs: each output within ATTN_RTOL of its
# Σ|terms| for fp32 summation orders, plus 2^-9 of it where the kernel rounds
# P or dS to bf16 as the Pallas kernel does
# (vqgan_tpu_torch/ops/attention.py::rounding_bounds), plus one bf16 ulp of
# the value for a bf16 output rounded on either side. lse: the logits'
# D-term sums in other orders, O(1e-6) of |S|
# the training job of phases 26-27 (the 2D CLI at the flagship width)
TRAIN_JOB = ["--vae_ch", "256", "--vae_ch_mult", "1,2,4,4", "--vae_num_res_blocks", "2",
             "--vae_z_channels", "16", "--vae_resolution", "256", "--batch_size", "8",
             "--image_size", "512", "--synthetic_data", "true", "--do_ganloss",
             "--disc_type", "hinge", "--use_lecam", "true", "--full_bf16", "true",
             "--evaluate_every_n_steps", "3", "--eval_batches", "1", "--use_wandb", "false",
             "--log_every", "1"]
# GroupNorms of one flagship VAE forward (encode 21 + decode 29): a train
# step's forward and backward launches each, and an eval's forward launches
JOB_GN = 50
JOB_EVAL_KEYS = ("eval/lpips", "eval/rfid_vgg_proxy", "eval/psnr", "eval/ssim")
ATTN_RTOL = 3e-5
ATTN_LSE_ATOL = 1e-4
# the TVAE clip configs: 16 frames x 128 px at batch 2 (TVAEConfig()), and the
# long clip, 48 frames x 256 px at batch 1 with ch_mult 1,2,4
CLIP_BATCH, CLIP_FRAMES, CLIP_RES = 2, 16, 128
LONG_FRAMES, LONG_RES, LONG_CHUNK = 48, 256, 1024
# (Ci, Co, T, H, W) -> kernel #6 calls per 16f/128px reconstruct, from the
# model (phase 19 checks them against what the pipeline runs)
ENCODER_CONV3D_SHAPES = {
    (3, 64, 16, 128, 128): 1, (64, 64, 16, 128, 128): 4, (64, 128, 8, 64, 64): 1,
    (128, 128, 8, 64, 64): 3, (128, 256, 4, 32, 32): 1, (256, 256, 4, 32, 32): 3,
    (256, 256, 2, 16, 16): 8, (256, 32, 2, 16, 16): 1,
}
DECODER_CONV3D_SHAPES = {
    (16, 256, 2, 16, 16): 1, (256, 256, 2, 16, 16): 10, (256, 256, 4, 32, 32): 7,
    (256, 256, 8, 64, 64): 1, (256, 128, 8, 64, 64): 1, (128, 128, 8, 64, 64): 5,
    (128, 128, 16, 128, 128): 1, (128, 64, 16, 128, 128): 1, (64, 64, 16, 128, 128): 5,
    (64, 3, 16, 128, 128): 1,
}
# kernel #6 off the path's shapes: (B, Ci, Co, T, H, W) in fp32 (and bf16 for
# the boundary cases): T = 1, Ci = Co = 3, ragged H/W with Co % 4 != 0, Ci
# not a multiple of 16, the split-K mid level
# the same for the 48f/256px long clip at batch 1 (ch_mult 1,2,4)
LONG_CONV3D_SHAPES = {
    (3, 64, 48, 256, 256): 1, (64, 64, 48, 256, 256): 9, (64, 128, 24, 128, 128): 1,
    (128, 128, 24, 128, 128): 8, (128, 256, 12, 64, 64): 1, (256, 256, 12, 64, 64): 17,
    (256, 32, 12, 64, 64): 1, (16, 256, 12, 64, 64): 1, (256, 256, 24, 128, 128): 1,
    (256, 128, 24, 128, 128): 1, (128, 128, 48, 256, 256): 1, (128, 64, 48, 256, 256): 1,
    (64, 3, 48, 256, 256): 1,
}
CONV3D_FP32_CASES = [(2, 64, 64, 4, 32, 32), (2, 3, 64, 4, 32, 32), (2, 256, 256, 2, 16, 16),
                     (2, 64, 3, 4, 32, 32)]
CONV3D_EDGE_CASES = [(1, 64, 64, 1, 16, 16), (1, 3, 3, 2, 8, 8), (1, 48, 40, 5, 37, 29),
                     (1, 20, 12, 3, 9, 11)]
# dk: a sum of B·T·H·W products per entry, in whatever order cuDNN takes;
# (n − 1)·u of Σ|terms| bounds any order's error against the fp64 value
# the 3D training steps (phases 23-24) at tools/bench_tvae.py's config: ch 64,
# ch_mult 1,2,4, 1 res block, z 8, bf16, gaussian, 16 frames x 128 px, batch 2
STEP3D_BATCH, STEP3D_FRAMES, STEP3D_RES = 2, 16, 128
# kernel launches per 3D step, counted from the model by forward hooks
# (phase 23 checks the hooks' count too): kernel #6 at each stride-1 3x3x3
# conv (encoder conv_in, 3 levels x 2, mid 4, conv_out = 12; decoder conv_in,
# mid 4, 3 levels x 4, 2 upsample convs, conv_out = 20), dx at each but the
# encoder's conv_in, whose input takes no gradient; GroupNorm forward and
# backward at each norm (encoder 12, decoder 18). Dense attention (4,096
# mid-block tokens, attn_chunk 0). The GAN step adds 2D modules only.
STEP3D_LAUNCHES = {"conv3d": 32, "conv3d_dx": 31, "gn": 30, "gn_bwd": 30}
# (Ci, Co, T, H, W) -> kernel #6 forward calls per 3D step at that config
# (phase 18 holds the forward and dx at each against plain)
STEP3D_CONV3D_SHAPES = {
    (3, 64, 16, 128, 128): 1, (64, 64, 16, 128, 128): 5, (64, 128, 8, 64, 64): 1,
    (128, 128, 8, 64, 64): 4, (128, 256, 4, 32, 32): 1, (256, 256, 4, 32, 32): 13,
    (256, 16, 4, 32, 32): 1, (8, 256, 4, 32, 32): 1, (256, 256, 8, 64, 64): 1,
    (256, 128, 8, 64, 64): 1, (128, 128, 16, 128, 128): 1, (128, 64, 16, 128, 128): 1,
    (64, 3, 16, 128, 128): 1,
}


def log(*args) -> None:
    print(*args, flush=True)


def set_tf32(enabled_for_convs: bool) -> None:
    torch.backends.cudnn.allow_tf32 = enabled_for_convs
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_steps(run_step, iters: int) -> tuple[dict, float]:
    """``iters`` calls of ``run_step`` (a training step, which updates its
    state in place and returns (state, metrics)), timed by the host clock
    from the first call to a fetch of the last step's loss, and by CUDA
    events recorded on the stream before the first call and after the last.
    Returns ({"step_s": host seconds a step, "last": the last (state,
    metrics)}, ms a step between the events)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        last = run_step()
    end.record()
    float(last[1]["overall_vae_loss"])  # waits for the device
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"step_s": seconds / iters, "last": last}, start.elapsed_time(end) / iters


def _shapes() -> list:
    return sorted(set(ENCODER_GN_SHAPES) | set(DECODER_GN_SHAPES))


def _gn_inputs(gen, batch: int, s: int, c: int, dtype, spatial: tuple = ()):
    """x (B, C, H, W) channels_last of H = W = √s, or (B, C, *spatial)
    channels_last_3d, in ``dtype`` with mean 0.3 and std 1.5, γ around 1, β
    around 0."""
    spatial = spatial or (int(round(s ** 0.5)),) * 2
    x = torch.randn((batch, *spatial, c), generator=gen, device="cuda")
    x = (x * 1.5 + 0.3).to(dtype).movedim(-1, 1)  # channels_last(_3d)
    w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    b = 0.5 * torch.randn(c, generator=gen, device="cuda")
    return x, w, b


def _library_forward(x, w, b, swish):
    """One PyTorch call of the same function, as a yardstick only (the port
    never calls it): F.group_norm (+ F.silu), with γ and β in x's dtype."""
    y = F.group_norm(x, 32, w.to(x.dtype), b.to(x.dtype), 1e-6)
    return F.silu(y) if swish else y


def bound_ms(n_bytes: int) -> float:
    """The least time the card needs to move ``n_bytes`` once."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def gn_check(gn, group_norm_fp32, x, w, b, swish: bool, label: str) -> tuple:
    """Kernel #1 against its plain version on x: y within ATOL_FP32 (fp32)
    or one bf16 ulp, two calls bitwise equal (y and the stats), one launch
    a call, and the kernel faster than plain. Times are the device's (CUDA
    graph replays): kernel, plain and library; the bound counts x read once
    and y written once. Raises where a check fails, else returns
    (max_abs_err, kernel_ms, plain_ms, library_ms, bound_ms)."""
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    plan = gn.forward_plan(x.shape[0], x[0, 0].numel(), x.shape[1], 32, x.element_size())
    gn.launches = 0
    got, stats = gn.group_norm_forward(x, w, b, 32, 1e-6, swish)
    torch.cuda.synchronize()
    one_count = gn.launches == 1
    again = gn.group_norm_forward(x, w, b, 32, 1e-6, swish)
    same = torch.equal(got, again[0]) and torch.equal(stats, again[1])
    del again
    ref = group_norm_fp32(x, w, b, 32, 1e-6, swish)
    torch.cuda.synchronize()
    diff = (got.float() - ref.float()).abs()
    err = float(diff.max())
    if x.dtype == torch.float32:
        ok = err <= ATOL_FP32
        tol = f"atol {ATOL_FP32:g}"
    else:
        ok = bool((diff <= 1e-6 + RTOL_BF16 * ref.float().abs()).all())
        tol = "1 bf16 ulp (rtol 2^-7)"
    del got, stats, ref, diff
    iters = 3 if x.numel() * 4 > 2**29 else 20  # the plain version's fp32 temporaries
    k_ms = device_ms(lambda: gn.group_norm_forward(x, w, b, 32, 1e-6, swish), 20)
    p_ms = device_ms(lambda: group_norm_fp32(x, w, b, 32, 1e-6, swish), iters)
    l_ms = device_ms(lambda: _library_forward(x, w, b, swish), iters)
    moved = 2 * x.numel() * x.element_size()
    b_ms = bound_ms(moved)
    name = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    ok = ok and same and one_count and k_ms < p_ms
    log(f"gn fwd {label} {name} swish={int(swish)}: "
        f"max_abs_err={err:.3e} ({tol}); bitwise repeat {same}, one launch a call "
        f"{one_count}; kernel_ms={k_ms:.4f} (device, {moved / k_ms / 1e9:.3f} TB/s, "
        f"{b_ms / k_ms:.3f} of the bound) plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"bound_ms={b_ms:.4f}; plan: {plan.describe()} {'ok' if ok else 'MISS'}")
    if not ok:
        raise AssertionError(f"forward kernel at {label} {name} swish={swish}: within bound "
                             f"{err}, bitwise {same}, one launch {one_count}, faster than "
                             f"plain {k_ms < p_ms}")
    return err, k_ms, p_ms, l_ms, b_ms


def phase_kernel_vs_plain(gn, group_norm_fp32, batch: int) -> dict:
    """Forward (phase 3) at every flagship shape and the width-96 VAE's
    (``gn_check``). Returns {(S, C, dtype, swish): (max_abs_err, kernel_ms,
    plain_ms, library_ms, bound_ms)}."""
    gen = torch.Generator(device="cuda").manual_seed(batch)
    out = {}
    for s, c in _shapes() + ODD_GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _gn_inputs(gen, batch, s, c, dtype)
            for swish in (False, True):
                out[(s, c, dtype, swish)] = gn_check(gn, group_norm_fp32, x, w, b, swish,
                                                     f"B={batch} S={s} C={c}")
            del x
            torch.cuda.empty_cache()
    return out


def gn_bwd_check(gn, group_norm_fp32_backward, x, g, w, b, swish: bool, label: str) -> tuple:
    """Kernel #2 against its plain version on (x, g): dx within ATOL_DX
    (fp32) or one bf16 ulp, dγ and dβ within SUM_RTOL of Σ|terms|, two calls
    bitwise equal, one launch a call, and the kernel faster than plain. Times
    are the device's (CUDA graph replays): kernel, plain and library (F.group_norm
    through autograd: its forward + backward less its forward), and the bound
    counts x and g read once and dx written once. Raises where a check fails,
    else returns (max_abs_err, kernel_ms, plain_ms, library_ms, bound_ms)."""
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    dtype = x.dtype
    b_, c = x.shape[:2]
    plan = gn.backward_plan(b_, x[0, 0].numel(), c, 32, x.element_size(),
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            blocks_per_sm=gn.backward_blocks_per_sm(0, dtype, swish))
    _, stats = gn.group_norm_forward(x, w, b, 32, 1e-6, swish)
    gn.bwd_launches = 0
    dx, dw, db = gn.group_norm_backward(x, g, stats, w, b, 32, swish)
    torch.cuda.synchronize()
    one_launch = gn.bwd_launches == 1
    again = gn.group_norm_backward(x, g, stats, w, b, 32, swish)
    same = all(torch.equal(p, q) for p, q in zip((dx, dw, db), again))
    del again
    mean, rstd = stats[:, 0], stats[:, 1]
    rdx, rdw, rdb = group_norm_fp32_backward(x, g, mean, rstd, w, b, 32, swish)
    torch.cuda.synchronize()
    ddx = (dx.float() - rdx.float()).abs()
    if dtype == torch.float32:
        ok_dx = float(ddx.max()) <= ATOL_DX
    else:
        ok_dx = bool((ddx <= ATOL_DX + RTOL_BF16 * rdx.float().abs()).all())
    # Σ|terms| per channel (|dŷ| <= 1.1·|g| with the swish)
    dims = (0, *range(2, x.ndim))
    ga = 1.1 * g.float().abs()
    t_beta = ga.sum(dim=dims)
    t_gamma = float(rstd.max()) * (ga * (x.float().abs() + float(mean.abs().max()))).sum(dim=dims)
    ok_dw = bool(((dw - rdw).abs() <= SUM_RTOL * t_gamma + 1e-6).all())
    ok_db = bool(((db - rdb).abs() <= SUM_RTOL * t_beta + 1e-6).all())
    errs = (float(ddx.max()), float((dw - rdw).abs().max()), float((db - rdb).abs().max()))
    del ga, ddx, rdx
    iters = 3 if x.numel() * 4 > 2**29 else 20  # the plain version's fp32 temporaries
    k_ms = device_ms(lambda: gn.group_norm_backward(x, g, stats, w, b, 32, swish), 20)
    p_ms = device_ms(lambda: group_norm_fp32_backward(x, g, mean, rstd, w, b, 32, swish), iters)
    xl = x.detach().requires_grad_()
    # detach first: for fp32, .to(dtype) would return w itself
    wl = w.detach().to(dtype).requires_grad_()
    bl = b.detach().to(dtype).requires_grad_()
    lf_ms = device_ms(lambda: _library_forward(xl, wl, bl, swish), iters)
    lfb_ms = device_ms(lambda: torch.autograd.grad(_library_forward(xl, wl, bl, swish),
                                                   (xl, wl, bl), g), iters)
    del xl, wl, bl
    b_ms = bound_ms(3 * x.numel() * x.element_size())
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    ok = ok_dx and ok_dw and ok_db and same and one_launch and k_ms < p_ms
    log(f"gn bwd {label} {name} swish={int(swish)}: max_abs_err dx={errs[0]:.3e} "
        f"dgamma={errs[1]:.3e} dbeta={errs[2]:.3e}; bitwise repeat {same}, one launch a "
        f"call {one_launch}; kernel_ms={k_ms:.4f} (device, "
        f"{3 * x.numel() * x.element_size() / k_ms / 1e9:.3f} TB/s) plain_ms={p_ms:.4f} "
        f"library_ms={lfb_ms - lf_ms:.4f} bound_ms={b_ms:.4f}; plan: {plan.describe()} "
        f"{'ok' if ok else 'MISS'}")
    if not ok:
        raise AssertionError(f"backward kernel at {label} {name} swish={swish}: dx {ok_dx} "
                             f"dgamma {ok_dw} dbeta {ok_db} bitwise {same} one launch "
                             f"{one_launch} faster than plain {k_ms < p_ms}")
    return max(errs), k_ms, p_ms, lfb_ms - lf_ms, b_ms


def phase_backward_vs_plain(gn, group_norm_fp32_backward, batch: int) -> dict:
    """Backward (phase 4) at every flagship shape and the width-96 VAE's,
    fp32 and bf16, swish on and off (``gn_bwd_check``). Returns {(S, C,
    dtype, swish): (max_abs_err, kernel_ms, plain_ms, library_ms,
    bound_ms)}."""
    gen = torch.Generator(device="cuda").manual_seed(100 + batch)
    out = {}
    for s, c in _shapes() + ODD_GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = _gn_inputs(gen, batch, s, c, dtype)
            g = _gn_inputs(gen, batch, s, c, dtype)[0] - 0.3
            for swish in (False, True):
                out[(s, c, dtype, swish)] = gn_bwd_check(
                    gn, group_norm_fp32_backward, x, g, w, b, swish, f"B={batch} S={s} C={c}")
            del x, g
            torch.cuda.empty_cache()
    return out


def gn_bwd_at_shapes(gn, shapes: dict, label: str) -> tuple[float, list]:
    """Kernel #2 against its plain version (``gn_bwd_check``) at each (B, C,
    T, H, W, dtype, swish) of ``shapes``, 5-D channels_last_3d, as a step's
    hooks recorded them; logs the sums of (kernel, plain, library, bound) ms
    over the calls and returns the largest max_abs_err and those sums."""
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32_backward

    gen = torch.Generator(device="cuda").manual_seed(24)
    err, sums = 0.0, [0.0] * 4
    for key in sorted(shapes, key=lambda k: (k[:5], str(k[5]), k[6])):
        b, c, t, h, w, dtype, swish = key
        x, wt, bs = _gn_inputs(gen, b, 0, c, dtype, (t, h, w))
        g = _gn_inputs(gen, b, 0, c, dtype, (t, h, w))[0] - 0.3
        res = gn_bwd_check(gn, group_norm_fp32_backward, x, g, wt, bs, swish,
                           f"{label} B={b} C={c} T={t} H={h} W={w} (S={t * h * w})")
        err = max(err, res[0])
        sums = [acc + shapes[key] * v for acc, v in zip(sums, res[1:])]
        del x, g
    torch.cuda.empty_cache()
    log(f"GN backward per {label} ({sum(shapes.values())} calls): kernel {sums[0]:.4f} ms, "
        f"plain {sums[1]:.4f} ms, library {sums[2]:.4f} ms, bound {sums[3]:.4f} ms (device time)")
    return err, sums


def per_step(results: dict, dtypes: dict) -> list:
    """Sums of (kernel, plain, library, bound) ms over the 50 GroupNorm calls
    of a flagship encode + decode, every call with swish, encoder calls in
    ``dtypes["enc"]`` and decoder calls in ``dtypes["dec"]``."""
    return [
        sum(n * results[(s, c, dtypes["enc"], True)][i] for (s, c), n in ENCODER_GN_SHAPES.items())
        + sum(n * results[(s, c, dtypes["dec"], True)][i]
              for (s, c), n in DECODER_GN_SHAPES.items())
        for i in (1, 2, 3, 4)
    ]


def phase_flagship(gn, tmp: str) -> tuple[int, dict]:
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.models.ae import init_vae
    from vqgan_tpu_torch.models.blocks import FP32GroupNorm
    from vqgan_tpu_torch.weights import save_weights

    set_tf32(True)  # PyTorch's defaults: TF32 convs, full-fp32 matmuls
    cfg = VAEConfig()
    t0 = time.perf_counter()
    model = init_vae(cfg, torch.Generator().manual_seed(0))
    path = os.path.join(tmp, "flagship.pt")
    save_weights(model, path)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    pipe = VAEPipeline.from_checkpoint(path, cfg, device="cuda")
    log(f"flagship: {n_params} params, init+save+load {time.perf_counter() - t0:.1f} s")

    seen = {}

    def record(module, args):
        x = args[0]
        key = (x.shape[2] * x.shape[3], x.shape[1], x.dtype)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record)
             for m in pipe.model.modules() if isinstance(m, FP32GroupNorm)]
    images = np.random.RandomState(0).randint(
        0, 256, (SERVE_BATCH, 256, 256, 3), np.uint8)

    gn.launches = 0
    z = pipe.encode(images)
    torch.cuda.synchronize()
    enc_launches = gn.launches
    gn.launches = 0
    recon = pipe.decode(z)
    dec_launches = gn.launches
    for h in hooks:
        h.remove()
    log(f"flagship: GN launches encode={enc_launches} decode={dec_launches}")
    if (enc_launches, dec_launches) != (21, 29):
        raise AssertionError("expected 21 GN launches per encode and 29 per decode")
    want = {(s, c, torch.float32): n for (s, c), n in ENCODER_GN_SHAPES.items()}
    for (s, c), n in DECODER_GN_SHAPES.items():
        want[(s, c, torch.bfloat16)] = n
    if seen != want:
        raise AssertionError(f"GN call shapes {seen} differ from {want}")

    if (tuple(z.shape) != (SERVE_BATCH, 32, 32, 16)
            or tuple(recon.shape) != (SERVE_BATCH, 256, 256, 3)):
        raise AssertionError(f"shapes: latents {tuple(z.shape)}, output {recon.shape}")
    if not bool(torch.isfinite(z).all()) or float(z.abs().max()) > 8.0:
        raise AssertionError("latents not finite or outside ±8")
    if not np.isfinite(recon).all() or recon.min() < 0.0 or recon.max() > 1.0:
        raise AssertionError("output not finite or outside [0, 1]")
    log(f"flagship: latents |z|max={float(z.abs().max()):.4f} std={float(z.std()):.4f}; "
        f"output mean={recon.mean():.4f} std={recon.std():.4f}")

    # the main path, counted: one reconstruct of the batch
    gn.launches = 0
    pipe.reconstruct(images)
    main_launches = gn.launches
    if main_launches != 50:
        raise AssertionError(f"{main_launches} GN launches in a reconstruct, expected 50")

    iters = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.reconstruct(images)  # ends in a device-to-host copy
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    enc_ms = cuda_ms(lambda: pipe.encode(images), iters=3, warmup=1)
    dec_ms = cuda_ms(lambda: pipe.decode(z), iters=3, warmup=1)
    result = {"img_per_s": SERVE_BATCH * iters / seconds,
              "reconstruct_s": seconds / iters,
              "encode_ms": enc_ms, "decode_ms": dec_ms, "peak_bytes": peak}
    log(f"flagship batch {SERVE_BATCH}: {result['img_per_s']:.3f} img/s, "
        f"{result['reconstruct_s'] * 1e3:.1f} ms per reconstruct "
        f"(encode {enc_ms:.1f} ms, decode {dec_ms:.1f} ms, CUDA events), "
        f"peak memory {peak / 2**30:.3f} GiB")
    return main_launches, result


def phase_train_flagship(gn, ac=None) -> tuple[dict, dict]:
    """The flagship training step at batch 8, with the mid-block attention
    when the attention kernels' module ``ac`` is given; returns the kernel
    launches of one counted step and the timings."""
    from vqgan_tpu_torch.tools.profile_step import build_flagship_step

    set_tf32(True)
    what = "train flagship" + (" attn" if ac else "")
    t0 = time.perf_counter()
    if ac:
        state, step, images = build_flagship_step(TRAIN_BATCH, use_attn=True,
                                                  attn_chunk=ATTN_CHUNK)
    else:
        state, step, images = build_flagship_step(TRAIN_BATCH)
    g_params = list(state.g_model.parameters())
    d_params = list(state.d_model.parameters())
    log(f"{what}: {sum(p.numel() for p in g_params)} G params, "
        f"{sum(p.numel() for p in d_params)} D params, batch {TRAIN_BATCH}, "
        f"build {time.perf_counter() - t0:.1f} s")

    def moved(params, before) -> bool:
        return any(not torch.equal(p, q) for p, q in zip(params, before))

    g0 = [p.detach().clone() for p in g_params]
    d0 = [p.detach().clone() for p in d_params]
    t0 = time.perf_counter()
    state, metrics = step(state, images)
    float(metrics["overall_vae_loss"])
    first_s = time.perf_counter() - t0
    if moved(g_params, g0):
        raise AssertionError("G moved in step 1, where its lr is 0")
    if not moved(d_params, d0):
        raise AssertionError("D did not move in step 1")
    state, metrics = step(state, images)
    if not moved(g_params, g0):
        raise AssertionError("G did not move in step 2")
    del g0, d0
    log(f"{what}: D moved in step 1, G in step 2 (first step {first_s:.2f} s)")

    # the main path, counted: one training step
    gn.launches = gn.bwd_launches = gn.grad_copies = 0
    if ac:
        ac.fwd_launches = ac.bwd_launches = ac.tc_launches = ac.fma_launches = 0
    state, metrics = step(state, images)
    torch.cuda.synchronize()
    counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches}
    want = {"gn": 50, "gn_bwd": 50}
    if ac:  # one AttnBlock in the encoder and one in the decoder
        counts.update(attn=ac.fwd_launches, attn_bwd=ac.bwd_launches)
        want = {"gn": 52, "gn_bwd": 52, "attn": 2, "attn_bwd": 2}
    log(f"{what}: kernel launches per step: {counts}; GroupNorm gradients copied into "
        f"channels_last first: {gn.grad_copies}")
    if counts != want:
        raise AssertionError(f"expected {want} kernel launches per step")
    if ac:  # bf16 encoder and decoder: all four calls on the tensor cores
        check_attn_route(ac, what, 4, 0)

    seconds, dev_ms = timed_steps(lambda: step(state, images), 5)
    state, metrics = seconds.pop("last")
    peak = torch.cuda.max_memory_allocated()
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    log(f"{what} metrics: " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(values.items())))
    result = {"img_per_s": TRAIN_BATCH / seconds["step_s"], "step_ms": seconds["step_s"] * 1e3,
              "device_step_ms": dev_ms, "peak_bytes": peak}
    log(f"{what} batch {TRAIN_BATCH}: {result['img_per_s']:.3f} img/s, "
        f"{result['step_ms']:.1f} ms per step (host clock over 5 steps), {dev_ms:.1f} ms per "
        f"step between CUDA events on the stream over the same steps, peak memory "
        f"{peak / 2**30:.3f} GiB")
    del state, step, images, metrics, g_params, d_params
    torch.cuda.empty_cache()
    return counts, result


def vq_distance_gap(z, cb, codes, ref):
    """Per token, in fp64: ‖z − E[codes]‖² − ‖z − E[ref]‖², and its fp32
    rounding bound (VQ_GAP_U)."""
    z, cb = z.double(), cb.double()
    a, b = cb[codes.long()], cb[ref.long()]
    gap = ((z - a) ** 2).sum(-1) - ((z - b) ** 2).sum(-1)
    tol = 2 * (z.shape[1] + 2) * VQ_GAP_U * (
        2 * (z * z).sum(-1) + (a * a).sum(-1) + (b * b).sum(-1))
    return gap, tol


def _library_nearest(z, cb, e_sq):
    """One PyTorch call of the search, as a yardstick only (the port never
    calls it): cuBLAS fp32 (TF32 off) writes the (N, K) matrix, then argmin."""
    return torch.addmm(e_sq, z, cb.T, alpha=-2.0).argmin(1)


def _library_stats(codes64, z, k, with_sums):
    """The statistics by PyTorch calls, as a yardstick only: index_add_
    (float atomics) of ones for the counts and of z for the sums
    (``bincount`` would give the counts too, but reads the largest code back
    to the host, so no CUDA graph can hold it)."""
    ones = torch.ones(codes64.shape[0], device=z.device)
    counts = torch.zeros(k, device=z.device).index_add_(0, codes64, ones)
    if with_sums:
        return counts, torch.zeros(k, z.shape[1], device=z.device).index_add_(0, codes64, z)
    return counts, None


def _near_tie_codebook(k, d, gen) -> torch.Tensor:
    """k // 2 random codes, each followed by a twin that differs in the last
    one or two mantissa bits of every column."""
    base = torch.randn((k // 2, d), generator=gen, device="cuda")
    step = torch.randint(0, 4, base.shape, generator=gen, device="cuda", dtype=torch.int32)
    twin = (base.view(torch.int32) + torch.tensor([-2, -1, 1, 2], device="cuda",
                                                   dtype=torch.int32)[step]).view(torch.float32)
    return torch.stack([base, twin], 1).reshape(k, d)


def phase_vq_kernels(vq) -> tuple[dict, dict]:
    """Kernels #4 and #5 against their plain versions, every time the
    device's (``device_ms``: calls replayed from a CUDA graph). Each kernel
    is also called twice on the same inputs, and the two results must be
    bitwise equal. Returns
    ({case: (gap, kernel_ms, plain_ms, library_ms, bound_ms)},
     {(case, with_sums): (max_abs_err, kernel_ms, plain_ms, library_ms,
     bound_ms)}); the search's bound is its three TF32 products at 495
    TFLOP/s, the one-product fp32 bound (67 TFLOP/s) logged beside it."""
    from vqgan_tpu_torch.ops.vq import code_stats_plain, nearest_codes_plain
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms
    from vqgan_tpu_torch.tools.time_vq import zipf_codes

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(7)
    nearest, stats = {}, {}

    def check_stats(name, codes, z, k, with_sums):
        n, d = z.shape
        counts, sums = vq.code_stats(codes, z, k, with_sums=with_sums)
        again = vq.code_stats(codes, z, k, with_sums=with_sums)
        r_counts, r_sums = code_stats_plain(codes, z, k, with_sums)
        torch.cuda.synchronize()
        repeat = torch.equal(counts, again[0]) and (not with_sums or torch.equal(sums, again[1]))
        ok = torch.equal(counts, r_counts) and float(counts.sum()) == n and repeat
        err = 0.0
        if with_sums:
            abs_sums = code_stats_plain(codes, z.abs(), k, True)[1]
            bound = 2 * (counts[:, None] - 1).clamp_min(0) * VQ_GAP_U * abs_sums + 1e-30
            diff = (sums - r_sums).abs()
            err = float(diff.max())
            ok = ok and bool((diff <= bound).all())
        codes64 = codes.long()
        k_ms = device_ms(lambda: vq.code_stats(codes, z, k, with_sums=with_sums), 20)
        p_ms = device_ms(lambda: code_stats_plain(codes, z, k, with_sums), 5)
        l_ms = device_ms(lambda: _library_stats(codes64, z, k, with_sums), 5)
        moved = n * 4 + k * 4 + ((n + k) * d * 4 if with_sums else 0)
        b_ms = bound_ms(moved)
        log(f"vq stats {name} N={n} K={k} D={d} {'sums' if with_sums else 'counts'}: "
            f"counts exact={torch.equal(counts, r_counts)} sum={float(counts.sum()):.0f} "
            f"largest count {int(counts.max())} sums max_abs_err={err:.3e} bitwise "
            f"repeatable={repeat} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={l_ms:.4f} bound_ms={b_ms:.5f} {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"statistics kernel disagrees with plain at {name}")
        stats[(name, with_sums)] = (err, k_ms, p_ms, l_ms, b_ms)

    for name, (n, k, d) in VQ_CASES.items():
        z = torch.randn((n, d), generator=gen, device="cuda")
        cb = torch.randn((k, d), generator=gen, device="cuda")
        got = vq.nearest_codes(z, cb)
        again = vq.nearest_codes(z, cb)
        ref = nearest_codes_plain(z, cb)
        torch.cuda.synchronize()
        repeat = torch.equal(got, again)
        gap, tol = vq_distance_gap(z, cb, got, ref)
        agree = int((got == ref).sum())
        ok = bool((gap.abs() <= tol).all()) and repeat
        e_sq = (cb * cb).sum(-1)
        k_ms = device_ms(lambda: vq.nearest_codes(z, cb), 20)
        p_ms = device_ms(lambda: nearest_codes_plain(z, cb), 5)
        l_ms = device_ms(lambda: _library_nearest(z, cb, e_sq), 5)
        bytes_ms = ((n * d + k * d) * 4 + n * 4) / HBM_BYTES_PER_S * 1e3
        fp32_ms = max(2 * n * k * d / FP32_FLOPS_PER_S * 1e3, bytes_ms)
        b_ms = max(3 * 2 * n * k * d / TF32_FLOPS_PER_S * 1e3, bytes_ms)
        worst = float(gap.max())
        log(f"vq nearest {name} N={n} K={k} D={d}: {agree}/{n} codes equal to plain, "
            f"max distance gap {worst:.3e} (bound {float(tol.max()):.3e}), bitwise "
            f"repeatable={repeat} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={l_ms:.4f} bound_ms={b_ms:.4f} (three TF32 products; one fp32 "
            f"product {fp32_ms:.4f}) {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"search kernel picks farther codes than plain at {name}")
        nearest[name] = (max(worst, 0.0), k_ms, p_ms, l_ms, b_ms)

        # the plain search's codes, with the skew a search gives
        for with_sums in (False, True):
            check_stats(name, ref, z, k, with_sums)
        del z, cb, got, again, ref, gap, tol

    n, k, d = VQ_CASES["flagship b8"]
    z = torch.randn((n, d), generator=gen, device="cuda")
    # Zipf-skewed codes: long runs in every tile
    check_stats("zipf", zipf_codes(n, k, gen), z, k, True)
    # a collapsed codebook: every token on one code, the longest runs there are
    check_stats("collapsed", torch.full((n,), 5, dtype=torch.int32, device="cuda"), z, k, True)

    # every code duplicated, copies in other tiles and splits: first copy wins
    z = torch.randn((n, d), generator=gen, device="cuda")
    base = torch.randn((k // 2, d), generator=gen, device="cuda")
    cb = torch.cat([base, base])
    got, ref = vq.nearest_codes(z, cb), nearest_codes_plain(z, cb)
    gap, tol = vq_distance_gap(z, cb, got, ref)
    ok = int(got.max()) < k // 2 and bool((gap.abs() <= tol).all())
    log(f"vq nearest ties N={n} K={k} (every code twice) D={d}: largest code "
        f"{int(got.max())} (< {k // 2} required), {int((got == ref).sum())}/{n} equal to "
        f"plain {'ok' if ok else 'MISS'}")
    if not ok:
        raise AssertionError("search kernel does not pick the first copy of a tie")

    # twin codes a few ulps apart: which twin wins is rounding, but the chosen
    # code stays within the bound of plain's, and of its pair
    cb = _near_tie_codebook(k, d, gen)
    got, ref = vq.nearest_codes(z, cb), nearest_codes_plain(z, cb)
    gap, tol = vq_distance_gap(z, cb, got, ref)
    pairs = float((got // 2 == ref // 2).float().mean())
    ok = bool((gap.abs() <= tol).all()) and pairs >= 0.99
    log(f"vq nearest near-tie N={n} K={k} (twins a few ulps apart) D={d}: "
        f"{int((got == ref).sum())}/{n} equal to plain, {pairs:.4f} of the same pair, max "
        f"distance gap {float(gap.max()):.3e} (bound {float(tol.max()):.3e}) "
        f"{'ok' if ok else 'MISS'}")
    if not ok:
        raise AssertionError("search kernel misses the bound on a near-tie codebook")
    return nearest, stats


def _codebook_rows(lat, cb) -> tuple[torch.Tensor, float]:
    """The codebook row nearest each latent vector, and the largest distance
    of a latent from its row."""
    from vqgan_tpu_torch.ops.vq import nearest_codes_plain

    flat = lat.reshape(-1, cb.shape[1]).float()
    idx = nearest_codes_plain(flat, cb)
    return idx, float((flat - cb[idx.long()]).abs().max())


def phase_vq_serving(gn, vq, tmp: str) -> tuple[dict, dict]:
    """VQ serving at the flagship width, batch 8; returns the counts of one
    reconstruct and the timings."""
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.models.ae import init_vae
    from vqgan_tpu_torch.weights import save_weights

    set_tf32(True)
    cfg = VAEConfig(reg_type="vq", vq_ema_decay=0.0)
    t0 = time.perf_counter()
    path = os.path.join(tmp, "flagship_vq.pt")
    save_weights(init_vae(cfg, torch.Generator().manual_seed(0)), path)
    pipe = VAEPipeline.from_checkpoint(path, cfg, device="cuda")
    log(f"vq flagship: K={cfg.vq_codebook_size} D={cfg.z_channels}, init+save+load "
        f"{time.perf_counter() - t0:.1f} s")
    images = np.random.RandomState(0).randint(0, 256, (SERVE_BATCH, 256, 256, 3), np.uint8)

    vq.nearest_launches = vq.stats_launches = 0
    z = pipe.encode(images)
    torch.cuda.synchronize()
    enc = (vq.nearest_launches, vq.stats_launches)
    cb = pipe.model.reg.codebook.detach()
    _, row_err = _codebook_rows(z, cb)
    # the straight-through z + (e − z) rounds twice at |z| <= 8: 2 ulps of 8
    ste_atol = 2 * 8 * 2.0 ** -23
    log(f"vq flagship: encode launches search={enc[0]} stats={enc[1]}; latents "
        f"{tuple(z.shape)}, largest distance from a codebook row {row_err:.3e} "
        f"(<= {ste_atol:.3e})")
    if enc != (1, 0):
        raise AssertionError("expected 1 search and no statistics launch per VQ encode")
    if tuple(z.shape) != (SERVE_BATCH, 32, 32, 16) or row_err > ste_atol:
        raise AssertionError("VQ latents are not codebook rows")

    # the main path, counted: one reconstruct of the batch
    gn.launches = gn.bwd_launches = vq.nearest_launches = vq.stats_launches = 0
    recon = pipe.reconstruct(images)
    counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches,
              "nearest": vq.nearest_launches, "stats": vq.stats_launches}
    log(f"vq flagship reconstruct launches: {counts}")
    if counts != {"gn": 50, "gn_bwd": 0, "nearest": 1, "stats": 0}:
        raise AssertionError("expected 50 GN and 1 search launch per VQ reconstruct")
    if not np.isfinite(recon).all() or recon.min() < 0.0 or recon.max() > 1.0:
        raise AssertionError("VQ output not finite or outside [0, 1]")

    iters = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        pipe.reconstruct(images)
    seconds = time.perf_counter() - t0
    result = {"img_per_s": SERVE_BATCH * iters / seconds, "reconstruct_s": seconds / iters,
              "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"vq flagship serving batch {SERVE_BATCH}: {result['img_per_s']:.3f} img/s, "
        f"{result['reconstruct_s'] * 1e3:.1f} ms per reconstruct, peak memory "
        f"{result['peak_bytes'] / 2**30:.3f} GiB")
    del pipe
    torch.cuda.empty_cache()
    return counts, result


def phase_train_vq_flagship(gn, vq) -> tuple[dict, dict]:
    """The flagship VQ training step at batch 8; returns the launches of one
    counted step and the timings."""
    from vqgan_tpu_torch.tools.profile_step import build_flagship_step

    set_tf32(True)
    t0 = time.perf_counter()
    state, step, images = build_flagship_step(TRAIN_BATCH, reg_type="vq")
    reg = state.g_model.reg
    log(f"vq train flagship: K={reg.codebook_size} D={reg.embedding_dim} EMA {reg.ema_decay}, "
        f"batch {TRAIN_BATCH}, build {time.perf_counter() - t0:.1f} s")
    counts0 = state.vq_ema["counts"].clone()
    cb0 = reg.codebook.detach().clone()
    t0 = time.perf_counter()
    state, metrics = step(state, images)
    float(metrics["vq_loss"])
    first_s = time.perf_counter() - t0
    used = int((state.vq_ema["counts"] > counts0 * reg.ema_decay + 1e-6).sum())
    cb_moved = float((reg.codebook.detach() - cb0).abs().max())
    log(f"vq train flagship: step 1 ({first_s:.2f} s) moved the EMA counts of {used} codes; "
        f"the fold moved the codebook by up to {cb_moved:.4e}")
    if used == 0 or cb_moved == 0.0:
        raise AssertionError("the EMA counts or the codebook did not move in step 1")
    del counts0, cb0

    # the main path, counted: one training step
    gn.launches = gn.bwd_launches = vq.nearest_launches = vq.stats_launches = 0
    state, metrics = step(state, images)
    torch.cuda.synchronize()
    counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches,
              "nearest": vq.nearest_launches, "stats": vq.stats_launches}
    log(f"vq train flagship: launches per step {counts}")
    if counts != {"gn": 50, "gn_bwd": 50, "nearest": 1, "stats": 1}:
        raise AssertionError("expected 50 + 50 GN, 1 search and 1 statistics launch per step")

    seconds, dev_ms = timed_steps(lambda: step(state, images), 5)
    state, metrics = seconds.pop("last")
    peak = torch.cuda.max_memory_allocated()
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not np.isfinite(v)]
    if bad or "vq_loss" not in values:
        raise AssertionError(f"non-finite or missing metrics: {bad}")
    log("vq train flagship metrics: " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(values.items())))
    result = {"img_per_s": TRAIN_BATCH / seconds["step_s"], "step_ms": seconds["step_s"] * 1e3,
              "device_step_ms": dev_ms, "peak_bytes": peak}
    log(f"vq train flagship batch {TRAIN_BATCH}: {result['img_per_s']:.3f} img/s, "
        f"{result['step_ms']:.1f} ms per step (host clock over 5 steps), {dev_ms:.1f} ms per "
        f"step between CUDA events on the stream over the same steps, peak memory "
        f"{peak / 2**30:.3f} GiB")
    del state, step, images, metrics, reg
    torch.cuda.empty_cache()
    return counts, result


def _perturbed_state_dict(cfg, seed: int) -> dict:
    """Reference init, then every residual branch and GroupNorm made
    non-trivial, so the comparison sees every path."""
    from vqgan_tpu_torch.models.ae import init_vae

    gen = torch.Generator().manual_seed(seed)
    model = init_vae(cfg, gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("conv2.weight"):
                bound = p[0].numel() ** -0.5
                p.uniform_(-bound, bound, generator=gen)
            elif p.ndim == 1 and ".norm" in name and name.endswith(".weight"):
                p.normal_(1.0, 0.2, generator=gen)
            elif name.endswith(".bias"):
                p.normal_(0.0, 0.1, generator=gen)
    return model.state_dict()


def _attn_kw(attn: bool) -> dict:
    """The reduced width's attention config: its mid block has 16x16 = 256
    tokens of 256 channels (4 heads of 64), above the chunk of 128."""
    return dict(use_attn=True, attn_chunk=128) if attn else {}


def phase_cross_device(attn: bool = False) -> None:
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.ops import attention_cuda as ac

    set_tf32(False)
    base = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                     z_channels=16, **_attn_kw(attn))
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3), np.uint8)
    for dec_dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dec_dtype=dec_dtype)
        sd = _perturbed_state_dict(cfg, seed=1)
        cpu = VAEPipeline(cfg, sd, device="cpu")
        gpu = VAEPipeline(cfg, sd, device="cuda")
        ac.fwd_launches = ac.tc_launches = ac.fma_launches = 0
        z_cpu, z_gpu = cpu.encode(images), gpu.encode(images).cpu()
        z_err = float((z_cpu - z_gpu).abs().max())
        # both decoders get the CPU latents, so the decode is compared alone
        r_cpu, r_gpu = cpu.decode(z_cpu), gpu.decode(z_cpu)
        r_err = np.abs(r_cpu - r_gpu)
        if ac.fwd_launches != (2 if attn else 0):
            raise AssertionError(f"{ac.fwd_launches} attention launches on the card")
        if attn:  # the fp32 encoder's call on FMA, the decoder's by its dtype
            bf16_dec = dec_dtype == "bfloat16"
            check_attn_route(ac, f"cross-device attn dec {dec_dtype}", int(bf16_dec),
                             2 - int(bf16_dec))
        log(f"cross-device {'attn ' if attn else ''}ch=64 (1,2,4) 64px, dec {dec_dtype}: "
            f"latents max_abs_err="
            f"{z_err:.3e} (|z|max {float(z_cpu.abs().max()):.3f}); decoded max_abs_err="
            f"{r_err.max():.3e} mean={r_err.mean():.3e}")
        if z_err > ATOL_PATH_FP32:
            raise AssertionError(f"latents differ across devices by {z_err}")
        if dec_dtype == "float32":
            ok = r_err.max() <= ATOL_PATH_FP32
        else:
            ok = r_err.mean() <= MEAN_TOL_PATH_BF16 and r_err.max() <= MAX_TOL_PATH_BF16
        if not ok:
            raise AssertionError(f"decoded images differ across devices ({dec_dtype})")


def phase_train_cross_device(vq_k: int = 0, attn: bool = False) -> None:
    """One training step on the CPU and on the card: same weights, batch and
    draws; fp32, TF32 off. ``vq_k`` > 0: the VQ latent with K = vq_k codes,
    EMA 0.9 and revival at 0.5, the EMA counts started from a numpy draw in
    [0.3, 1.3) so that unused codes are revived, and the same K revival rows
    on both devices; then the EMA statistics and the folded codebook are
    compared too. ``attn``: with the mid-block attention (phase 17), whose
    kernels must run on the card."""
    from vqgan_tpu_torch.config import TrainConfig, VAEConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.ops import attention_cuda as ac
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    set_tf32(False)
    extra_kw = _attn_kw(attn)
    if vq_k:
        extra_kw |= dict(reg_type="vq", vq_codebook_size=vq_k, vq_ema_decay=0.9,
                     vq_revive_threshold=0.5)
    vae_cfg = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                        z_channels=16, enc_dtype="float32", dec_dtype="float32", **extra_kw)
    # D's lr: AdamW's first step moves every D param by ±lr·sign(grad); where
    # a gradient is rounding noise the two devices step apart, and G's GAN
    # branch through the updated D carries that into G's gradient
    # (tests/test_torch_train_step.py). At 1e-8 D's update stays below it.
    cfg = TrainConfig(batch_size=2, image_size=64, max_steps=10_000, do_ganloss=True,
                      disc_type="hinge", use_lecam=True, do_clamp=True,
                      flip_invariance=True, learning_rate_disc=1e-8)
    sd_vae = _perturbed_state_dict(vae_cfg, seed=2)
    gen = torch.Generator().manual_seed(3)
    disc_ref = PatchDiscriminator()
    init_discriminator_(disc_ref, gen)
    with torch.no_grad():  # non-zero final heads: the GAN branch reaches G
        for k in range(1, 6):
            getattr(disc_ref, f"binary_classifier{k}")[-1].weight.normal_(0.0, 0.05,
                                                                          generator=gen)
    lpips_ref = LPIPS()
    init_lpips_(lpips_ref, gen)
    images = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    revive_idx, vq_ema = None, None
    if vq_k:
        rng = np.random.RandomState(4)
        sd_vae["reg.codebook"] = torch.from_numpy(
            (0.5 * rng.randn(vq_k, 16)).astype(np.float32))
        n_tokens = 2 * 16 * 16
        revive_idx = torch.from_numpy(rng.randint(0, n_tokens, vq_k))
        counts = torch.from_numpy(rng.uniform(0.3, 1.3, vq_k).astype(np.float32))
        vq_ema = {"counts": counts, "sums": counts[:, None] * sd_vae["reg.codebook"]}
    runs, tape = {}, DecisionTape()
    for run in ("cpu", "cuda", "cuda free"):
        dev = run.split()[0]
        with torch.device(dev):
            vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
        vae.load_state_dict(sd_vae, strict=True)
        disc.load_state_dict(disc_ref.state_dict(), strict=True)
        lpips.load_state_dict(lpips_ref.state_dict(), strict=True)
        state = create_train_state(cfg, vae, disc, vae_cfg.ch, vq_ema=vq_ema)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        draws = StepDraws(flip_in=True, flip_w=True, flip_h=False, crop_h=0, crop_w=0,
                          aug_lpips_w=False, aug_lpips_h=False,
                          revive_idx=None if revive_idx is None else revive_idx.to(dev))
        ac.fwd_launches = ac.bwd_launches = ac.tc_launches = ac.fma_launches = 0
        head = {"lpips": lpips, "disc": disc}
        with (tape.recording(head) if run == "cpu" else
              tape.replaying(head) if run == "cuda" else contextlib.nullcontext()):
            state, metrics = step(state, torch.from_numpy(images).to(dev), 0, draws)
        if attn and dev == "cuda" and (ac.fwd_launches, ac.bwd_launches) != (2, 2):
            raise AssertionError("the card's step did not run 2 + 2 attention launches")
        if attn and dev == "cuda":  # fp32 throughout: the FMA route
            check_attn_route(ac, "cross-device attn training step", 0, 4)
        moments = {}
        for side, model, opt in (("G", vae, state.g_opt), ("D", disc, state.d_opt)):
            # in EMA mode the codebook takes no gradient and has no AdamW state
            moments[side] = {n: opt.state[p]["exp_avg"].cpu()
                             for n, p in model.named_parameters() if p in opt.state}
        extra = {}
        if vq_k:
            extra = {"counts": state.vq_ema["counts"].cpu(), "sums": state.vq_ema["sums"].cpu(),
                     "codebook": vae.reg.codebook.detach().cpu()}
        runs[run] = ({k: float(v) for k, v in metrics.items()}, moments, extra)

    log(f"train cross-device: {tape.describe()} recorded on the CPU, replayed on the card")
    what = (f"vq K={vq_k} " if vq_k else "") + ("attn " if attn else "")
    n_logits = 2 * 2 * 16  # real and fake, batch 2, a 4x4 patch grid at 64 px
    compare_step_across_devices(runs, f"{what}ch=64 (1,2,4) 64px batch 2", n_logits, vq_k)


class DecisionTape:
    """The loss head's discrete decisions in one training step, recorded on
    one run and replayed on another, so that two runs of the step differ by
    rounding alone: every ReLU's mask and every max-pool's argmax in the
    VGG16 towers of LPIPS and D and in D's classifier heads, per module and
    call, in call order. ``recording`` keeps them (the CPU's run);
    ``replaying`` makes the same modules take them instead of their own (the
    card's run): a ReLU returns x·mask, a max-pool pools x with -inf off the
    recorded argmaxes, and the gradient follows the same masks and indices. Installed
    by forward hooks on the modules given; the port's modules do not change.
    A one-ulp change of a pre-activation near 0 flips a ReLU and moves 1-2 %
    of a gradient (tools/cross_device_spread.py), which no bound on
    rounding can hold."""

    def __init__(self):
        self.calls: dict[str, list[torch.Tensor]] = {}
        self._next: dict[str, int] = {}

    @staticmethod
    def decision_modules(modules: dict) -> list:
        """(name, module) of every ReLU and max-pool under ``modules``
        ({prefix: root module})."""
        return [(f"{prefix}.{name}", m) for prefix, root in modules.items()
                for name, m in root.named_modules()
                if isinstance(m, (torch.nn.ReLU, torch.nn.MaxPool2d))]

    def _record(self, key, module, inputs, output):
        x = inputs[0]
        if isinstance(module, torch.nn.ReLU):
            decision = x > 0
        else:
            with torch.no_grad():
                decision = F.max_pool2d(x, module.kernel_size, module.stride, module.padding,
                                        module.dilation, module.ceil_mode, True)[1]
        self.calls.setdefault(key, []).append(decision.detach().cpu())

    def _replay(self, key, module, inputs, output):
        i = self._next.get(key, 0)
        if i >= len(self.calls.get(key, ())):
            raise AssertionError(f"{key} called more often than on the recorded run")
        self._next[key] = i + 1
        x, decision = inputs[0], self.calls[key][i].to(inputs[0].device)
        if isinstance(module, torch.nn.ReLU):
            return x * decision.to(x.dtype)
        # the pool again over x with -inf off the recorded argmaxes: the same
        # values, the gradient to the same elements, in the pool's own layout
        off = torch.full_like(x, float("-inf"))
        off.flatten(2).scatter_(2, decision.flatten(2), 0.0)
        return F.max_pool2d(x + off, module.kernel_size, module.stride, module.padding,
                            module.dilation, module.ceil_mode)

    @contextlib.contextmanager
    def _hooked(self, modules: dict, hook):
        handles = [m.register_forward_hook(functools.partial(hook, key))
                   for key, m in self.decision_modules(modules)]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()

    def recording(self, modules: dict):
        self.calls.clear()
        return self._hooked(modules, self._record)

    @contextlib.contextmanager
    def replaying(self, modules: dict):
        self._next.clear()
        with self._hooked(modules, self._replay):
            yield self
        unused = {k: len(v) - self._next.get(k, 0) for k, v in self.calls.items()
                  if len(v) != self._next.get(k, 0)}
        if unused:
            raise AssertionError(f"recorded decisions left unused: {unused}")

    def describe(self) -> str:
        n = sum(len(v) for v in self.calls.values())
        elems = sum(t.numel() for v in self.calls.values() for t in v)
        return f"{n} decisions ({elems} elements) of {len(self.calls)} modules"


def step_bound_shares(ref: tuple, got: tuple, n_logits: int) -> tuple:
    """One training step's (metrics, AdamW first moments of G and D) against
    the reference run's, by phase 8's bounds: (the worst loss's share of
    LOSS_RTOL/ATOL, {side: (the worst tensor, its share of GRAD_RTOL of the
    tensor's largest entry + GRAD_FLOOR of the largest)}, [the losses past
    their bound], [the gradients past theirs]). D's accuracy: one logit of
    ``n_logits``."""
    (m_ref, g_ref), (m_got, g_got) = ref[:2], got[:2]
    bad_loss, bad_grad = [], []
    for k, v in m_ref.items():
        atol = 1.0 / n_logits if k == "gan/discriminator_accuracy" else LOSS_ATOL
        if abs(m_got[k] - v) > atol + LOSS_RTOL * abs(v):
            bad_loss.append((k, v, m_got[k]))
    worst_loss = max(abs(m_got[k] - v) / (LOSS_ATOL + LOSS_RTOL * abs(v))
                     for k, v in m_ref.items() if k != "gan/discriminator_accuracy")
    worst = {}
    for side in ("G", "D"):
        r_side, o_side = g_ref[side], g_got[side]
        if set(r_side) != set(o_side):
            bad_grad.append((side, "parameters with AdamW state differ"))
            continue
        floor = GRAD_FLOOR * max(float(t.abs().max()) for t in r_side.values())
        used = {}
        for n, r in r_side.items():
            scale = float(r.abs().max())
            err = float((o_side[n] - r).abs().max())
            used[n] = err / (GRAD_RTOL * scale + floor)
            if err > GRAD_RTOL * scale + floor:
                bad_grad.append((side, n, err, scale))
        name = max(used, key=used.get)
        worst[side] = (name, used[name])
    return worst_loss, worst, bad_loss, bad_grad


def compare_step_across_devices(runs: dict, what: str, n_logits: int, vq_k: int) -> None:
    """One training step's (metrics, AdamW first moments of G and D, VQ
    statistics) on the CPU (``runs["cpu"]``, its loss head's decisions
    recorded) and on the card with those decisions replayed
    (``runs["cuda"]``, ``DecisionTape``), against phase 8's bounds: losses
    LOSS_RTOL/ATOL (D's accuracy one logit of ``n_logits``), gradients
    GRAD_RTOL of each tensor's largest entry + GRAD_FLOOR of the largest;
    with ``vq_k`` the EMA counts to one token, the sums and the folded
    codebook to ATOL_PATH_FP32, some code revived. ``runs["cuda free"]``,
    where given, is the card's step without the replay: its losses, which
    the flips move only a little, are held to the same loss bounds, and its
    gradients' share is printed for information."""
    (m_cpu, _, x_cpu), (m_gpu, _, x_gpu) = runs["cpu"], runs["cuda"]
    worst_loss, worst, bad_loss, bad_grad = step_bound_shares(runs["cpu"], runs["cuda"],
                                                              n_logits)
    bad = bad_loss + bad_grad
    log(f"train cross-device {what}: overall_vae_loss cpu="
        f"{m_cpu['overall_vae_loss']:.6f} card={m_gpu['overall_vae_loss']:.6f}; the worst "
        f"loss uses {worst_loss:.3f} of its bound")
    for side, (name, share) in worst.items():
        log(f"train cross-device {what} {side} step-1 gradients (AdamW exp_avg), the loss "
            f"head's decisions replayed from the CPU: the worst tensor, {name}, uses "
            f"{share:.3f} of its bound (rtol {GRAD_RTOL:g}, floor {GRAD_FLOOR:g} of the largest "
            f"entry)")
    if "cuda free" in runs:
        free_loss, free, free_bad_loss, _ = step_bound_shares(runs["cpu"], runs["cuda free"],
                                                              n_logits)
        bad += [("without replay",) + b for b in free_bad_loss]
        log(f"train cross-device {what}, the card's own decisions: the worst loss uses "
            f"{free_loss:.3f} of its bound; gradients (for information): " + ", ".join(
                f"{side} {name} {share:.3f}" for side, (name, share) in free.items()))
    if vq_k:
        if "reg.codebook" in runs["cuda"][1]["G"]:
            bad.append("the EMA codebook has AdamW state")
        # the counts: 0.9·c + 0.1·(integer counts), the same fp32 operations on
        # both devices. A token on the other side of a near-tie would move two
        # codes by 0.1: at most one such token is allowed, and printed
        dc = (x_gpu["counts"] - x_cpu["counts"]).abs()
        flips = float(dc.sum()) / (2 * 0.1)
        # the sums and the folded codebook average or copy z rows, which the
        # two devices' fp32 convs give within ATOL_PATH_FP32
        ds = float((x_gpu["sums"] - x_cpu["sums"]).abs().max())
        dcb = float((x_gpu["codebook"] - x_cpu["codebook"]).abs().max())
        revived = int((x_cpu["counts"] < 0.5).sum())
        log(f"train cross-device {what} EMA counts: {int((dc == 0).sum())}/{vq_k} equal, "
            f"{flips:.2f} tokens' worth of difference; sums max_abs_err={ds:.3e}; folded "
            f"codebook max_abs_err={dcb:.3e} ({revived} codes revived)")
        if flips > 1.0 + 1e-3 or ds > ATOL_PATH_FP32 or dcb > ATOL_PATH_FP32 or revived == 0:
            bad.append(("vq statistics", flips, ds, dcb, revived))
    if bad:
        raise AssertionError(f"training step differs across devices: {bad[:10]}")


def phase_vq_cross_device() -> None:
    """VQ serving on the CPU and on the card at the reduced width: the
    latents' codes compared by distance from the CPU's z. The two devices'
    encoders agree within ATOL_PATH_FP32 per entry, so a code picked
    differently may be up to 2·‖δz‖·‖E_a − E_b‖ farther beyond rounding."""
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline

    set_tf32(False)
    cfg = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                    z_channels=16, reg_type="vq", vq_codebook_size=VQ_CROSS_K,
                    vq_ema_decay=0.0)
    sd = _perturbed_state_dict(cfg, seed=5)
    sd["reg.codebook"] = torch.from_numpy(
        (0.5 * np.random.RandomState(5).randn(VQ_CROSS_K, 16)).astype(np.float32))
    images = np.random.RandomState(6).randint(0, 256, (2, 64, 64, 3), np.uint8)
    cpu = VAEPipeline(cfg, sd, device="cpu")
    gpu = VAEPipeline(cfg, sd, device="cuda")
    cb = sd["reg.codebook"]
    z_pre = cpu.model.encode(cpu._to_model_input(images)).clamp(-8, 8).detach()
    z_pre = z_pre.reshape(-1, 16)
    codes_cpu, err_cpu = _codebook_rows(cpu.encode(images), cb)
    codes_gpu, err_gpu = _codebook_rows(gpu.encode(images).cpu(), cb)
    gap, tol = vq_distance_gap(z_pre, cb, codes_gpu, codes_cpu)
    shift = 2 * 4 * ATOL_PATH_FP32 * (cb[codes_gpu.long()] - cb[codes_cpu.long()]).norm(dim=-1)
    agree = int((codes_gpu == codes_cpu).sum())
    ok = bool((gap <= tol + shift.double()).all()) and max(err_cpu, err_gpu) <= 1e-5
    log(f"vq cross-device ch=64 (1,2,4) 64px K={VQ_CROSS_K}: {agree}/{codes_cpu.numel()} "
        f"codes equal, max distance gap {float(gap.max()):.3e}; latents within "
        f"{max(err_cpu, err_gpu):.2e} of codebook rows {'ok' if ok else 'MISS'}")
    if not ok:
        raise AssertionError("VQ serving picks farther codes on the card than on the CPU")


def _library_attention(q, k, v):
    """One PyTorch call of the same function, as a yardstick only (the port
    never calls it): scaled_dot_product_attention on (B, H, N, D) views."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2))


@functools.cache
def sfu_exps_per_s() -> float:
    """The card's exp rate: SFU_EXPS_PER_CLOCK_SM x its SMs x its highest SM
    clock (``nvidia-smi`` clocks.max.sm)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_EXPS_PER_CLOCK_SM * sms * float(mhz) * 1e6


def attention_flops(b, n, h, d, backward: bool) -> int:
    """4·B·H·N²·D forward (two products); 10·B·H·N²·D backward (the four
    products and S recomputed): what the function needs, not what kernel
    #3's backward does (14, S and dP recomputed twice)."""
    return (10 if backward else 4) * b * h * n * n * d


def attention_bound_ms(b, n, h, d, dtype, backward: bool) -> float:
    """The least time of one call: the largest of its operations at the peak
    rate of the inputs' type (``attention_flops``), its exps at the SFU's
    rate (one per score forward, one backward: P recomputed) and its bytes at
    3.35 TB/s (q, k, v read and out written, plus out and dO read and dq, dk,
    dv written backward; the fp32 lse written forward and read backward)."""
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    es = torch.finfo(dtype).bits // 8
    moved = (8 if backward else 4) * b * n * h * d * es + 4 * b * h * n
    return max(attention_flops(b, n, h, d, backward) / rate, b * h * n * n / sfu_exps_per_s(),
               moved / HBM_BYTES_PER_S) * 1e3


def check_attn_route(ac, what: str, tc: int, fma: int) -> None:
    """The kernel #3 calls since the route counts were set to 0: ``tc`` bf16
    calls on the tensor cores and ``fma`` fp32 calls on the CUDA cores."""
    log(f"{what}: kernel #3 routes: {ac.tc_launches} tensor-core, {ac.fma_launches} FMA")
    if (ac.tc_launches, ac.fma_launches) != (tc, fma):
        raise AssertionError(f"{what}: expected {tc} bf16 attention calls on the tensor cores "
                             f"and {fma} fp32 calls on the FMA route")


def phase_attention_kernels(ac) -> dict:
    """Kernel #3 against its plain versions (phase 13): fp32 (the FMA route)
    and bf16 (the tensor-core route) at every case, the route of every call
    counted; each output within ``rounding_bounds``, lse within
    ATTN_LSE_ATOL. Times are the device's (``device_ms``: calls replayed from
    a CUDA graph), the wrapper's CUDA-event time beside them. Fails where a
    bf16 call is slower than its plain version, or two runs of the bf16
    backward differ in a bit. Returns {(case, dtype, "fwd" or "bwd"):
    (max_abs_err, kernel_ms, plain_ms, library_ms, bound_ms)}."""
    from vqgan_tpu_torch.ops.attention import (
        chunked_attention_backward,
        chunked_attention_forward,
        rounding_bounds,
    )
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, (b, n, h, d, chunk, with_bwd) in ATTN_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tname = "bf16" if bf16 else "fp32"
            # q, k, v: views of one (B, N, 3, H, D) tensor, as the AttnBlock's
            qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda").to(dtype)
            q, k, v = qkv.unbind(2)
            ac.tc_launches = ac.fma_launches = 0
            o, lse = ac.attention_forward(q, k, v, chunk)
            ro, rlse = chunked_attention_forward(q, k, v, chunk)
            pairs = {"out": (o, ro)}
            if with_bwd:
                g = torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
                # both backwards from the plain forward's residuals
                grads = ac.attention_backward(q, k, v, ro, rlse, g, chunk)
                ref = chunked_attention_backward(q, k, v, ro, rlse, g, chunk)
                pairs.update(zip(("dq", "dk", "dv"), zip(grads, ref)))
                delta = (g.float() * ro.float()).sum(-1).transpose(1, 2)
                bounds = rounding_bounds(q, k, v, rlse, ATTN_RTOL, bf16, g, delta)
            else:
                bounds = rounding_bounds(q, k, v, rlse, ATTN_RTOL, bf16)
            torch.cuda.synchronize()
            calls = 2 if with_bwd else 1
            check_attn_route(ac, f"attn {name} {tname}", calls if bf16 else 0,
                             0 if bf16 else calls)
            lse_err = float((lse - rlse).abs().max())
            used = {"lse": lse_err / ATTN_LSE_ATOL}
            errs = {}
            for key, (got, want) in pairs.items():
                diff = (got.float() - want.float()).abs()
                tol = bounds[key] + 1e-7
                if bf16:
                    tol = tol + 2.0 ** -7 * want.float().abs()
                used[key] = float((diff / tol).max())
                errs[key] = float(diff.max())
            del bounds, pairs, diff, tol
            ok = all(u <= 1.0 for u in used.values())
            if with_bwd and bf16:  # the backward sums in a fixed order
                again = ac.attention_backward(q, k, v, ro, rlse, g, chunk)
                if not all(torch.equal(x, y) for x, y in zip(grads, again)):
                    raise AssertionError(f"attention backward {name} bf16 not deterministic")
                del again
            iters = 3 if n > 4096 else 20
            f_ms = device_ms(lambda: ac.attention_forward(q, k, v, chunk), iters)
            fw_ms = cuda_ms(lambda: ac.attention_forward(q, k, v, chunk), iters=iters)
            pf_ms = device_ms(lambda: chunked_attention_forward(q, k, v, chunk), iters)
            lf_ms = device_ms(lambda: _library_attention(q, k, v), iters)
            fb = attention_bound_ms(b, n, h, d, dtype, backward=False)
            tflops = attention_flops(b, n, h, d, backward=False) / f_ms / 1e9
            log(f"attn fwd {name} B={b} N={n} H={h} D={d} {tname}: max_abs_err "
                f"out={errs['out']:.3e} lse={lse_err:.3e}; share of the bound used "
                f"out={used['out']:.3f} lse={used['lse']:.3f} kernel_ms={f_ms:.4f} (device; "
                f"wrapper {fw_ms:.4f}) {tflops:.1f} TFLOP/s plain_ms={pf_ms:.4f} "
                f"library_ms={lf_ms:.4f} (kernel/SDPA {f_ms / lf_ms:.2f}) bound_ms={fb:.4f} "
                f"{'ok' if ok else 'MISS'}")
            out[(name, dtype, "fwd")] = (max(errs["out"], lse_err), f_ms, pf_ms, lf_ms, fb)
            slow = [f"fwd {f_ms:.4f} against plain {pf_ms:.4f}"] if bf16 and f_ms >= pf_ms else []
            if with_bwd:
                b_ms = device_ms(lambda: ac.attention_backward(q, k, v, ro, rlse, g, chunk),
                                 iters)
                bw_ms = cuda_ms(lambda: ac.attention_backward(q, k, v, ro, rlse, g, chunk),
                                iters=iters)
                pb_ms = device_ms(lambda: chunked_attention_backward(q, k, v, ro, rlse, g,
                                                                     chunk), iters)
                ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
                gl = g.transpose(1, 2)

                def fwd_bwd():
                    torch.autograd.grad(_library_attention(ql, kl, vl), (ql, kl, vl), gl)

                # SDPA's backward: its forward + backward less its forward
                lfb_ms = device_ms(fwd_bwd, iters)
                lb_ms = lfb_ms - lf_ms
                del ql, kl, vl
                bb = attention_bound_ms(b, n, h, d, dtype, backward=True)
                tflops = attention_flops(b, n, h, d, backward=True) / b_ms / 1e9
                log(f"attn bwd {name} B={b} N={n} H={h} D={d} {tname}: max_abs_err "
                    + " ".join(f"{key}={errs[key]:.3e}" for key in ("dq", "dk", "dv"))
                    + "; share of the bound used "
                    + " ".join(f"{key}={used[key]:.3f}" for key in ("dq", "dk", "dv"))
                    + f" kernel_ms={b_ms:.4f} (device; wrapper {bw_ms:.4f}) {tflops:.1f} "
                    f"TFLOP/s of 10·BHN²D ({tflops * 1.4:.1f} of the 14 it does) "
                    f"plain_ms={pb_ms:.4f} library_ms={lb_ms:.4f} (library forward+backward "
                    f"{lfb_ms:.4f}; kernel/SDPA {b_ms / lb_ms:.2f}) bound_ms={bb:.4f} "
                    f"{'ok' if ok else 'MISS'}")
                out[(name, dtype, "bwd")] = (max(errs[key] for key in ("dq", "dk", "dv")),
                                             b_ms, pb_ms, lb_ms, bb)
                if bf16 and b_ms >= pb_ms:
                    slow.append(f"bwd {b_ms:.4f} against plain {pb_ms:.4f}")
                del g, grads, ref, delta
            if not ok:
                raise AssertionError(f"attention kernel disagrees with plain at {name} "
                                     f"{tname}: {used}")
            if slow:
                raise AssertionError(f"attention kernel slower than plain at {name} bf16: "
                                     + ", ".join(slow))
            del qkv, q, k, v, o, lse, ro, rlse
            torch.cuda.empty_cache()
    return out


def _serve_and_time(pipe, images, iters: int) -> dict:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        recon = pipe.reconstruct(images)  # ends in a device-to-host copy
    seconds = time.perf_counter() - t0
    if not np.isfinite(recon).all() or recon.min() < 0.0 or recon.max() > 1.0:
        raise AssertionError("output not finite or outside [0, 1]")
    return {"img_per_s": len(images) * iters / seconds, "reconstruct_s": seconds / iters,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_attn_serving(gn, ac, tmp: str) -> tuple[dict, dict, dict]:
    """Flagship serving with the mid-block attention at batch 8 (phase 14),
    then the same .pt at 1,024 px, batch 1 (phase 15). Returns the counts of
    one flagship reconstruct and the two timings."""
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.models.ae import init_vae
    from vqgan_tpu_torch.weights import save_weights

    set_tf32(True)
    cfg = VAEConfig(use_attn=True, attn_chunk=ATTN_CHUNK)
    t0 = time.perf_counter()
    path = os.path.join(tmp, "flagship_attn.pt")
    save_weights(init_vae(cfg, torch.Generator().manual_seed(0)), path)
    pipe = VAEPipeline.from_checkpoint(path, cfg, device="cuda")
    log(f"attn flagship: attn_chunk={cfg.attn_chunk}, init+save+load "
        f"{time.perf_counter() - t0:.1f} s")
    images = np.random.RandomState(0).randint(0, 256, (SERVE_BATCH, 256, 256, 3), np.uint8)

    stages = {}
    gn.launches = ac.fwd_launches = ac.bwd_launches = 0
    z = pipe.encode(images)
    torch.cuda.synchronize()
    stages["encode"] = (gn.launches, ac.fwd_launches, ac.bwd_launches)
    gn.launches = ac.fwd_launches = 0
    recon = pipe.decode(z)
    stages["decode"] = (gn.launches, ac.fwd_launches, ac.bwd_launches)
    log(f"attn flagship: (GN, attention forward, attention backward) launches {stages}")
    if stages != {"encode": (22, 1, 0), "decode": (30, 1, 0)}:
        raise AssertionError("expected 22 GN and 1 attention launch per encode, 30 and 1 per "
                             "decode")
    if (tuple(z.shape) != (SERVE_BATCH, 32, 32, 16) or not bool(torch.isfinite(z).all())
            or float(z.abs().max()) > 8.0 or tuple(recon.shape) != (SERVE_BATCH, 256, 256, 3)):
        raise AssertionError("attention flagship latents or output out of shape or range")

    # the main path, counted: one reconstruct of the batch
    gn.launches = ac.fwd_launches = ac.tc_launches = ac.fma_launches = 0
    pipe.reconstruct(images)
    counts = {"gn": gn.launches, "attn": ac.fwd_launches, "attn_bwd": ac.bwd_launches}
    log(f"attn flagship reconstruct launches: {counts}")
    if counts != {"gn": 52, "attn": 2, "attn_bwd": 0}:
        raise AssertionError("expected 52 GN and 2 attention launches per reconstruct")
    check_attn_route(ac, "attn flagship reconstruct (fp32 encoder, bf16 decoder)", 1, 1)
    flagship = _serve_and_time(pipe, images, iters=3)
    log(f"attn flagship serving batch {SERVE_BATCH}: {flagship['img_per_s']:.3f} img/s, "
        f"{flagship['reconstruct_s'] * 1e3:.1f} ms per reconstruct, peak memory "
        f"{flagship['peak_bytes'] / 2**30:.3f} GiB")
    del pipe
    torch.cuda.empty_cache()

    hr_cfg = VAEConfig(resolution=1024, use_attn=True, attn_chunk=HIRES_CHUNK)
    pipe = VAEPipeline.from_checkpoint(path, hr_cfg, device="cuda")
    image = np.random.RandomState(1).randint(0, 256, (1, 1024, 1024, 3), np.uint8)
    ac.fwd_launches = ac.tc_launches = ac.fma_launches = 0
    z = pipe.encode(image)
    if tuple(z.shape) != (1, 128, 128, 16) or not bool(torch.isfinite(z).all()):
        raise AssertionError("high-resolution latents not finite or out of shape")
    pipe.decode(z)
    if ac.fwd_launches != 2:
        raise AssertionError(f"{ac.fwd_launches} attention launches in a 1,024 px reconstruct")
    check_attn_route(ac, "attn 1,024 px reconstruct (fp32 encoder, bf16 decoder)", 1, 1)
    hires = _serve_and_time(pipe, image, iters=2)
    log(f"attn high-res serving 1024 px batch 1 (16384 mid-block tokens, attn_chunk="
        f"{HIRES_CHUNK}): {hires['img_per_s']:.3f} img/s, {hires['reconstruct_s'] * 1e3:.1f} "
        f"ms per reconstruct, peak memory {hires['peak_bytes'] / 2**30:.3f} GiB")
    del pipe
    torch.cuda.empty_cache()
    return counts, flagship, hires


def _conv3d_case(gen, b, ci, co, t, h, w, dtype):
    """x (B, Ci, T, H, W) channels_last_3d and an OIDHW weight of unit-scale
    outputs, in ``dtype``."""
    x = torch.randn((b, t, h, w, ci), generator=gen, device="cuda").to(dtype)
    wt = torch.randn((co, ci, 3, 3, 3), generator=gen, device="cuda") / (27 * ci) ** 0.5
    return x.permute(0, 4, 1, 2, 3), wt.to(dtype)


def conv3d_bound_ms(m: int, ci: int, co: int, dtype) -> float:
    """The least time of one call over M voxels: the larger of its 2·27·Ci·Co
    operations per voxel at the peak rate of the inputs' type and its bytes
    (x and the weight read once, y written once) at 3.35 TB/s."""
    flops = 2 * 27 * ci * co * m
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    es = torch.finfo(dtype).bits // 8
    return max(flops / rate, (m * (ci + co) + 27 * ci * co) * es / HBM_BYTES_PER_S) * 1e3


class _OneSplit:
    """Within the block, kernel #6's launch plan keeps K whole (splits = 1):
    the split-K plan's yardstick."""

    def __init__(self, cc):
        self.cc, self.plan = cc, cc.launch_plan

    def __enter__(self):
        def one(*args):
            plan = self.plan(*args)
            return dataclasses.replace(plan, splits=1, chunks_per_split=plan.n_chunks)

        self.cc.launch_plan = one

    def __exit__(self, *exc):
        self.cc.launch_plan = self.plan


def _tc_plan(cc, b, ci, co, t, h, w) -> str:
    plan = cc.launch_plan(b * t * h * w, ci, co, cc.num_sms(0), torch.bfloat16)
    return f"tile {plan.block_m}x{plan.block_n} splits {plan.splits}"


def check_tc_route(cc, what: str) -> None:
    """Every kernel #6 call since the counts were set to 0 (forward and dx)
    took the bf16 tensor-core route: none the fp32 FMA route."""
    total = cc.launches + cc.bwd_launches
    log(f"{what}: kernel #6 routes: {cc.tc_launches} tensor-core, {cc.fma_launches} FMA of "
        f"{total} calls")
    if cc.tc_launches != total or cc.fma_launches != 0:
        raise AssertionError(f"{what}: expected all {total} Conv3d calls on the tensor cores")


def phase_conv3d_kernels(cc) -> tuple[dict, dict, dict]:
    """Kernel #6 against its plain versions (phase 18): both routes, forward
    and dx. bf16 (tensor cores) at every shape of the 16f/128px clip, the
    long clip and the 3D training config, and at the edge cases; there also
    the fp32 sums before the cast (``conv3d_forward_sums``) against the fp32
    plain version of the same bf16 inputs, with no bf16 ulp: the tensor
    cores' accumulation alone. fp32 (CUDA-core FMA) at the fp32 and edge
    cases. Returns ({(B, Ci, Co, T, H, W, dtype): (max_abs_err, kernel_ms,
    plain_ms, library_ms, bound_ms)} for the forward, the same for dx, and
    {(B, Ci, Co, T, H, W): ([forward splits, dx splits], forward ms, forward
    ms at one split, dx ms, dx ms at one split)} for the bf16 path shapes
    whose forward or dx plan splits K). Every time is the device's
    (``device_ms``: calls replayed from a CUDA graph, no host work between
    them). Fails where the kernel is slower than its plain version, or the
    split plan slower than one split, at a bf16 path shape."""
    from vqgan_tpu_torch.ops.conv3d import (
        bound_share,
        conv3d_input_grad_plain,
        conv3d_plain,
        flipped_weight,
    )
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(18)
    clip = {(CLIP_BATCH, *s) for s in set(ENCODER_CONV3D_SHAPES) | set(DECODER_CONV3D_SHAPES)}
    path = sorted(clip | {(1, *s) for s in LONG_CONV3D_SHAPES}
                  | {(STEP3D_BATCH, *s) for s in STEP3D_CONV3D_SHAPES})
    cases = [(c, torch.bfloat16) for c in path]
    cases += [(c, torch.float32) for c in CONV3D_FP32_CASES + CONV3D_EDGE_CASES]
    cases += [(c, torch.bfloat16) for c in CONV3D_EDGE_CASES]
    fwd, bwd, split = {}, {}, {}
    sums_used = 0.0
    for (b, ci, co, t, h, w), dtype in cases:
        x, wt = _conv3d_case(gen, b, ci, co, t, h, w, dtype)
        dy = _conv3d_case(gen, b, co, ci, t, h, w, dtype)[0]
        wl = wt.contiguous(memory_format=torch.channels_last_3d)
        wf = flipped_weight(wt)
        cc.tc_launches = cc.fma_launches = 0
        y, dx = cc.conv3d_forward(x, wt), cc.conv3d_input_grad(dy, wt)
        torch.cuda.synchronize()
        route = {torch.bfloat16: (2, 0), torch.float32: (0, 2)}[dtype]
        if (cc.tc_launches, cc.fma_launches) != route:
            raise AssertionError(f"conv3d {dtype} took the routes (tc, fma) "
                                 f"{(cc.tc_launches, cc.fma_launches)}, not {route}")
        ref, ref_dx = conv3d_plain(x, wt), conv3d_input_grad_plain(dy, wt)
        used = [bound_share(y, ref, x, wt), bound_share(dx, ref_dx, dy, wf)]
        errs = [float((y.float() - ref.float()).abs().max()),
                float((dx.float() - ref_dx.float()).abs().max())]
        del y, dx, ref, ref_dx
        sums = ""
        if dtype == torch.bfloat16:
            # the tensor cores' fp32 sums, no bf16 rounding: fp32 bound alone
            s_used = [bound_share(cc.conv3d_forward_sums(a, k), conv3d_plain(a.float(),
                                                                             k.float()),
                                  a.float(), k.float()) for a, k in ((x, wt), (dy, wf))]
            used += s_used
            sums_used = max(sums_used, *s_used)
            sums = f" fp32 sums used fwd={s_used[0]:.4f} dx={s_used[1]:.4f};"
        m = b * t * h * w
        iters = 5 if m * ci * co > 2 ** 30 else 20
        times = [device_ms(fn, iters) for fn in (
            lambda: cc.conv3d_forward(x, wt), lambda: conv3d_plain(x, wt),
            lambda: F.conv3d(x, wl, padding=1),
            lambda: cc.conv3d_input_grad(dy, wt), lambda: conv3d_input_grad_plain(dy, wt),
            lambda: torch.nn.grad.conv3d_input(x.shape, wl, dy, padding=1))]
        fb, bb = conv3d_bound_ms(m, ci, co, dtype), conv3d_bound_ms(m, co, ci, dtype)
        tname = "bf16" if dtype == torch.bfloat16 else "fp32"
        plans = ""
        if dtype == torch.bfloat16:
            plans = (f" [fwd {_tc_plan(cc, b, ci, co, t, h, w)}, dx "
                     f"{_tc_plan(cc, b, co, ci, t, h, w)}]")
        flop = 2 * 27 * ci * co * m
        ok = max(used) <= 1.0
        log(f"conv3d B={b} Ci={ci} Co={co} T={t} H={h} W={w} {tname}{plans}: share of the "
            f"bound used fwd={used[0]:.3f} (max_abs_err {errs[0]:.3e}) dx={used[1]:.3f} "
            f"(max_abs_err {errs[1]:.3e});{sums} fwd kernel_ms={times[0]:.4f} "
            f"({flop / times[0] / 1e9:.1f} TFLOP/s) plain_ms={times[1]:.4f} "
            f"library_ms={times[2]:.4f} bound_ms={fb:.4f}; dx kernel_ms={times[3]:.4f} "
            f"({flop / times[3] / 1e9:.1f} TFLOP/s) plain_ms={times[4]:.4f} "
            f"library_ms={times[5]:.4f} bound_ms={bb:.4f} {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"conv3d kernel disagrees with plain at {(b, ci, co, t, h, w)} "
                                 f"{tname}: {used}")
        key = (b, ci, co, t, h, w, dtype)
        fwd[key] = (errs[0], *times[:3], fb)
        bwd[key] = (errs[1], *times[3:], bb)
        plans = [cc.launch_plan(m, i, o, cc.num_sms(x.device.index), dtype)
                 for i, o in ((ci, co), (co, ci))]
        splits = [plan.splits for plan in plans]
        if max(splits) > 1 and (b, ci, co, t, h, w) in path and dtype == torch.bfloat16:
            # the same calls with K kept whole, held against plain too, and
            # timed against the plan on the device
            with _OneSplit(cc):
                one = [bound_share(cc.conv3d_forward(x, wt), conv3d_plain(x, wt), x, wt),
                       bound_share(cc.conv3d_input_grad(dy, wt), conv3d_input_grad_plain(dy, wt),
                                   dy, wf)]
            ms = [device_ms(lambda p=p, tr=tr, a=a: cc._launch(a, wt, p, transpose=tr), iters)
                  for a, tr, plan in ((x, False, plans[0]), (dy, True, plans[1]))
                  for p in (plan, dataclasses.replace(plan, splits=1,
                                                      chunks_per_split=plan.n_chunks))]
            log(f"conv3d split-K B={b} Ci={ci} Co={co} T={t} H={h} W={w} bf16, device "
                f"time: fwd {ms[0]:.4f} ms at {splits[0]} splits, {ms[1]:.4f} ms at 1 "
                f"(share of the bound used {one[0]:.3f}); dx {ms[2]:.4f} ms at "
                f"{splits[1]} splits, {ms[3]:.4f} ms at 1 (used {one[1]:.3f})")
            if max(one) > 1.0:
                raise AssertionError(f"conv3d kernel at one split disagrees with plain at "
                                     f"{(b, ci, co, t, h, w)}: {one}")
            split[(b, ci, co, t, h, w)] = (splits, *ms)
        del x, wt, wl, wf, dy
        torch.cuda.empty_cache()
    slower = [(k, v) for k, v in split.items()
              if (v[0][0] > 1 and v[1] > v[2]) or (v[0][1] > 1 and v[3] > v[4])]
    behind = [(k[:6], v[1], v[2], bwd[k][1], bwd[k][2]) for k, v in fwd.items()
              if k[:6] in path and k[6] == torch.bfloat16
              and (v[1] > v[2] or bwd[k][1] > bwd[k][2])]
    log(f"conv3d: every bf16 call on the tensor cores; fp32 sums use at most "
        f"{sums_used:.4f} of the fp32 bound; device time: the kernel is slower than its plain "
        f"version at {len(behind)} of the {len(path)} bf16 path shapes"
        + "".join(f"; {k}: {a:.4f}/{p:.4f} fwd, {c:.4f}/{q:.4f} dx" for k, a, p, c, q in behind)
        + f"; the split-K plan is slower than one split at {len(slower)} of the "
        f"{len(split)} path shapes that split"
        + "".join(f"; {k}: {v[1]:.4f}/{v[2]:.4f} fwd, {v[3]:.4f}/{v[4]:.4f} dx"
                  for k, v in slower))
    if behind or slower:
        raise AssertionError("conv3d: the kernel is slower than its plain version, or the "
                             "split-K plan than one split, at a path shape")

    # dx and dk through the autograd Function, fp32: dx against the plain
    # version, dk (cuDNN's weight gradient) against fp64 within (n − 1)·u of
    # its Σ|terms|, the bound of any summation order of n terms
    for b, ci, co, t, h, w in [(1, 64, 64, 4, 16, 16), (1, 256, 256, 2, 16, 16)]:
        x, wt = _conv3d_case(gen, b, ci, co, t, h, w, torch.float32)
        g = _conv3d_case(gen, b, co, ci, t, h, w, torch.float32)[0]
        xg, wg = x.detach().requires_grad_(), wt.detach().requires_grad_()
        cc.bwd_launches = 0
        y = cc.conv3d_ttap(xg, wg)
        if y.grad_fn is None:
            raise AssertionError("conv3d_ttap's output on the card has no grad_fn")
        y.backward(g)
        dk_ref = torch.nn.grad.conv3d_weight(x.double(), wt.shape, g.double(), padding=1)
        dk_terms = torch.nn.grad.conv3d_weight(x.abs().double(), wt.shape, g.abs().double(),
                                               padding=1)
        n = b * t * h * w
        dk_used = float(((wg.grad.double() - dk_ref).abs()
                         / ((n - 1) * 2.0 ** -24 * dk_terms + 1e-30)).max())
        dx_used = bound_share(xg.grad, conv3d_input_grad_plain(g, wt), g, flipped_weight(wt))
        ok = cc.bwd_launches == 1 and dk_used <= 1.0 and dx_used <= 1.0
        log(f"conv3d autograd B={b} Ci={ci} Co={co} T={t} H={h} W={w} fp32: {cc.bwd_launches} "
            f"dx launch, share of the bound used dx={dx_used:.3f} dk={dk_used:.3f} "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError("conv3d autograd on the card disagrees")
        del x, wt, g, xg, wg, y
    return fwd, bwd, split


def clip_conv3d_calls(backward: bool = False) -> dict:
    """(Ci, Co, T, H, W) -> kernel #6 calls of one 16f/128px reconstruct;
    with ``backward`` the dx calls of its backward: every one but the
    encoder's conv_in, whose input takes no gradient (the dx of a conv is
    keyed by its forward's shape)."""
    calls = dict(ENCODER_CONV3D_SHAPES)
    for s, n in DECODER_CONV3D_SHAPES.items():
        calls[s] = calls.get(s, 0) + n
    if backward:
        calls[(3, 64, CLIP_FRAMES, CLIP_RES, CLIP_RES)] -= 1
    return calls


def per_reconstruct(results: dict, batch: int, calls: dict) -> list:
    """Sums of (kernel, plain, library, bound) ms over ``calls`` at
    ``batch``, bf16."""
    return [sum(n * results[(batch, *s, torch.bfloat16)][i] for s, n in calls.items())
            for i in (1, 2, 3, 4)]


def record_conv3d_shapes(model) -> tuple[dict, list]:
    """Forward pre-hooks on the model's Conv3d modules that count, by (Ci,
    Co, T, H, W), the calls that take kernel #6: the dict and the hooks."""
    from vqgan_tpu_torch.models.tae import Conv3d

    seen = {}

    def record(module, args):
        x = args[0]
        if module.uses_kernel(x):
            key = (x.shape[1], module.weight.shape[0], *x.shape[2:])
            seen[key] = seen.get(key, 0) + 1

    return seen, [m.register_forward_pre_hook(record) for m in model.modules()
                  if isinstance(m, Conv3d)]


def record_gn_shapes(model) -> tuple[dict, list]:
    """Forward pre-hooks on the model's GroupNorms that count the calls by
    (B, C, T, H, W, dtype, swish): the dict and the hooks."""
    from vqgan_tpu_torch.models.blocks import FP32GroupNorm

    seen = {}

    def record(module, args):
        key = (*args[0].shape, args[0].dtype, module.fused_swish)
        seen[key] = seen.get(key, 0) + 1

    return seen, [m.register_forward_pre_hook(record) for m in model.modules()
                  if isinstance(m, FP32GroupNorm)]


def gn_at_clip_shapes(gn, shapes: dict, label: str) -> float:
    """Kernel #1 against its plain version (``gn_check``) at each (B, C, T,
    H, W, dtype, swish) of ``shapes``, 5-D channels_last_3d, as a clip
    reconstruct or a 3D step ran them; logs the sums of (kernel, plain,
    library, bound) ms over the calls and returns the largest max_abs_err."""
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32

    gen = torch.Generator(device="cuda").manual_seed(19)
    err, sums = 0.0, [0.0] * 4
    for key in sorted(shapes, key=lambda k: (k[:5], str(k[5]), k[6])):
        b, c, t, h, w, dtype, swish = key
        x, wt, bs = _gn_inputs(gen, b, 0, c, dtype, (t, h, w))
        res = gn_check(gn, group_norm_fp32, x, wt, bs, swish,
                       f"{label} B={b} C={c} T={t} H={h} W={w} (S={t * h * w})")
        err = max(err, res[0])
        sums = [acc + shapes[key] * v for acc, v in zip(sums, res[1:])]
        del x
        torch.cuda.empty_cache()
    log(f"GN forward per {label} ({sum(shapes.values())} calls, device time): "
        f"kernel {sums[0]:.4f} ms, plain {sums[1]:.4f} ms, library {sums[2]:.4f} ms, bound "
        f"{sums[3]:.4f} ms")
    return err


def _clip_model(cfg, tmp: str, name: str):
    """Random TVAE weights from a seed, written as a reference-format .pt,
    served through TVAEPipeline.from_checkpoint on the card."""
    from vqgan_tpu_torch.inference import TVAEPipeline
    from vqgan_tpu_torch.models.tae import init_tvae
    from vqgan_tpu_torch.weights import save_weights

    t0 = time.perf_counter()
    path = os.path.join(tmp, name)
    model = init_tvae(cfg, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    save_weights(model, path)
    del model
    pipe = TVAEPipeline.from_checkpoint(path, cfg, device="cuda")
    log(f"{name}: {n_params} params, init+save+load {time.perf_counter() - t0:.1f} s")
    return pipe, path


def _serve_clips(pipe, clips, iters: int) -> dict:
    # untimed: after a torch.cuda.empty_cache() (gn_at_clip_shapes) the first
    # reconstruct allocates its device memory anew
    pipe.reconstruct(clips)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        recon = pipe.reconstruct(clips)  # ends in a device-to-host copy
    seconds = time.perf_counter() - t0
    if not np.isfinite(recon).all() or recon.min() < 0.0 or recon.max() > 1.0:
        raise AssertionError("clip output not finite or outside [0, 1]")
    return {"frames_per_s": clips.shape[0] * clips.shape[1] * iters / seconds,
            "reconstruct_s": seconds / iters, "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_clip_serving(gn, cc, ac, tmp: str) -> tuple[dict, dict, dict]:
    """TVAE clip serving at 16f/128px, batch 2 (phase 19). Returns the
    launches of one counted reconstruct, the timings, and the launches and
    time of one backward of a reconstruct loss."""
    from vqgan_tpu_torch.config import TVAEConfig
    from vqgan_tpu_torch.inference import TVAEPipeline

    set_tf32(True)
    cfg = TVAEConfig(resolution=CLIP_RES)
    pipe, path = _clip_model(cfg, tmp, "tvae_16f128.pt")
    seen, hooks = record_conv3d_shapes(pipe.model)
    gn_seen, gn_hooks = record_gn_shapes(pipe.model)
    clips = np.random.RandomState(0).randint(
        0, 256, (CLIP_BATCH, CLIP_FRAMES, CLIP_RES, CLIP_RES, 3), np.uint8)
    stages = {}
    cc.launches = cc.bwd_launches = cc.tc_launches = cc.fma_launches = 0
    gn.launches = ac.fwd_launches = 0
    z = pipe.encode(clips)
    torch.cuda.synchronize()
    stages["encode"] = (cc.launches, gn.launches, ac.fwd_launches)
    enc_seen = dict(seen)
    seen.clear()
    cc.launches = gn.launches = ac.fwd_launches = 0
    recon = pipe.decode(z)
    stages["decode"] = (cc.launches, gn.launches, ac.fwd_launches)
    cc.launches = stages["encode"][0] + stages["decode"][0]
    check_tc_route(cc, "tvae 16f/128px encode + decode")
    for h in hooks + gn_hooks:
        h.remove()
    log(f"tvae 16f/128px: (Conv3d, GroupNorm, attention) launches {stages}")
    if stages != {"encode": (22, 22, 0), "decode": (33, 30, 0)}:
        raise AssertionError("expected 22 Conv3d and 22 GroupNorm launches per encode, 33 and "
                             "30 per decode, dense attention")
    if enc_seen != ENCODER_CONV3D_SHAPES or seen != DECODER_CONV3D_SHAPES:
        raise AssertionError(f"Conv3d shapes {enc_seen} {seen} differ from the tables")
    want = (CLIP_BATCH, CLIP_FRAMES // 8, CLIP_RES // 8, CLIP_RES // 8, cfg.z_channels)
    if tuple(z.shape) != want or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"latents {tuple(z.shape)} not {want} or not finite")
    if (recon.shape != (CLIP_BATCH, CLIP_FRAMES, CLIP_RES, CLIP_RES, 3)
            or not np.isfinite(recon).all() or recon.min() < 0.0 or recon.max() > 1.0):
        raise AssertionError("clip output out of shape, not finite or outside [0, 1]")
    log(f"tvae 16f/128px: latents {tuple(z.shape)} |z|max={float(z.abs().max()):.4f} "
        f"std={float(z.float().std()):.4f}; output mean={recon.mean():.4f} std={recon.std():.4f}")
    gn_err = gn_at_clip_shapes(gn, gn_seen, "16f/128px reconstruct")

    # the main path, counted: one reconstruct of the batch
    cc.launches = cc.bwd_launches = cc.tc_launches = cc.fma_launches = 0
    gn.launches = ac.fwd_launches = 0
    pipe.reconstruct(clips)
    counts = {"conv3d": cc.launches, "conv3d_dx": cc.bwd_launches, "gn": gn.launches,
              "attn": ac.fwd_launches}
    log(f"tvae 16f/128px reconstruct launches: {counts}")
    if counts != {"conv3d": 55, "conv3d_dx": 0, "gn": 52, "attn": 0}:
        raise AssertionError("expected 55 Conv3d and 52 GroupNorm launches per reconstruct")
    check_tc_route(cc, "tvae 16f/128px reconstruct")
    timing = _serve_clips(pipe, clips, iters=3)
    log(f"tvae 16f/128px serving batch {CLIP_BATCH}: {timing['frames_per_s']:.3f} frames/s, "
        f"{timing['reconstruct_s'] * 1e3:.1f} ms per reconstruct, peak memory "
        f"{timing['peak_bytes'] / 2**30:.3f} GiB")

    # the gradient of a reconstruct loss: the next slice's training path
    model = pipe.model
    x = pipe._to_model_input(clips)
    cc.launches = cc.bwd_launches = cc.tc_launches = cc.fma_launches = gn.bwd_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec = model.decode(model.deterministic_latent(model.encode(x)))
    dec.float().square().mean().backward()
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grads = [p.grad for p in model.parameters()]
    backward = {"conv3d": cc.launches, "conv3d_dx": cc.bwd_launches, "gn_bwd": gn.bwd_launches}
    finite = all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    log(f"tvae 16f/128px reconstruct-loss forward+backward: {grad_s * 1e3:.1f} ms (host clock, "
        f"first call), launches {backward}, every parameter gradient finite: {finite}")
    if backward != {"conv3d": 55, "conv3d_dx": 54, "gn_bwd": 52} or not finite:
        raise AssertionError("expected 55 forward, 54 dx and 52 GroupNorm backward launches "
                             "and finite gradients")
    check_tc_route(cc, "tvae 16f/128px reconstruct-loss forward+backward")
    del model, x, dec, grads
    pipe.model.zero_grad(set_to_none=True)

    # the yardstick: the same weights through cuDNN's Conv3d
    direct = TVAEPipeline.from_checkpoint(path, dataclasses.replace(cfg, conv3d_impl="direct"),
                                          device="cuda")
    del pipe
    torch.cuda.empty_cache()
    direct.reconstruct(clips)
    cc.launches = 0
    yard = _serve_clips(direct, clips, iters=3)
    log(f"tvae 16f/128px serving with conv3d_impl=direct (cuDNN, a yardstick): "
        f"{yard['frames_per_s']:.3f} frames/s, {yard['reconstruct_s'] * 1e3:.1f} ms per "
        f"reconstruct, peak memory {yard['peak_bytes'] / 2**30:.3f} GiB, {cc.launches} "
        f"kernel #6 launches")
    timing["direct_frames_per_s"] = yard["frames_per_s"]
    timing["gn_err"] = gn_err
    del direct
    torch.cuda.empty_cache()
    return counts, timing, {**backward, "seconds": grad_s}


def phase_long_clip(gn, cc, ac, tmp: str) -> dict:
    """Long-clip serving at 48f/256px, batch 1, attn_chunk 1024 (phase 20)."""
    from vqgan_tpu_torch.config import TVAEConfig

    set_tf32(True)
    cfg = TVAEConfig(resolution=LONG_RES, ch_mult=(1, 2, 4), attn_chunk=LONG_CHUNK)
    pipe, _ = _clip_model(cfg, tmp, "tvae_48f256.pt")
    clip = np.random.RandomState(1).randint(0, 256, (1, LONG_FRAMES, LONG_RES, LONG_RES, 3),
                                            np.uint8)
    seen, hooks = record_conv3d_shapes(pipe.model)
    gn_seen, gn_hooks = record_gn_shapes(pipe.model)
    stages = {}
    cc.launches = cc.bwd_launches = cc.tc_launches = cc.fma_launches = 0
    gn.launches = ac.fwd_launches = ac.tc_launches = ac.fma_launches = 0
    z = pipe.encode(clip)
    torch.cuda.synchronize()
    stages["encode"] = (cc.launches, gn.launches, ac.fwd_launches)
    cc.launches = gn.launches = ac.fwd_launches = 0
    recon = pipe.decode(z)
    stages["decode"] = (cc.launches, gn.launches, ac.fwd_launches)
    cc.launches = stages["encode"][0] + stages["decode"][0]
    check_tc_route(cc, "tvae long clip 48f/256px encode + decode")
    for h in hooks + gn_hooks:
        h.remove()
    if seen != LONG_CONV3D_SHAPES:
        raise AssertionError(f"long-clip Conv3d shapes {seen} differ from the table")
    tokens = (LONG_FRAMES // 4) * (LONG_RES // 4) ** 2
    log(f"tvae long clip 48f/256px ({tokens} mid-block tokens, attn_chunk {LONG_CHUNK}): "
        f"(Conv3d, GroupNorm, attention) launches {stages}")
    if stages != {"encode": (18, 18, 1), "decode": (26, 24, 1)}:
        raise AssertionError("expected 18 + 26 Conv3d, 18 + 24 GroupNorm, 1 + 1 attention "
                             "launches")
    check_attn_route(ac, "tvae long clip 48f/256px encode + decode (bf16)", 2, 0)
    want = (1, LONG_FRAMES // 4, LONG_RES // 4, LONG_RES // 4, cfg.z_channels)
    if (tuple(z.shape) != want or not bool(torch.isfinite(z).all())
            or recon.shape != (1, LONG_FRAMES, LONG_RES, LONG_RES, 3)
            or not np.isfinite(recon).all() or recon.min() < 0.0 or recon.max() > 1.0):
        raise AssertionError("long-clip latents or output out of shape or range")
    gn_err = gn_at_clip_shapes(gn, gn_seen, "48f/256px reconstruct")
    timing = _serve_clips(pipe, clip, iters=2)
    log(f"tvae long clip serving batch 1: {timing['frames_per_s']:.3f} frames/s, "
        f"{timing['reconstruct_s'] * 1e3:.1f} ms per reconstruct, peak memory "
        f"{timing['peak_bytes'] / 2**30:.3f} GiB")
    timing["gn_err"] = gn_err
    del pipe
    torch.cuda.empty_cache()
    return timing


def phase_tvae_cross_device(cc, ac, ch_mult=(1, 8)) -> None:
    """TVAE serving on the CPU and on the card (phase 21): ch=32, ``ch_mult``
    1,8 (or 1,4), 1 res block, 4 frames x 32 px, attn_chunk 64 (512
    mid-block tokens of 256 channels, 8 heads of 32; or of 128, 8 heads of
    16). The CPU runs the direct Conv3d, the card kernels #6, #1 and #3. fp32, TF32 off: ATOL_PATH_FP32. bf16: each conv
    output is rounded to bf16 on either device after sums in other orders,
    with the bias added before (CPU) or after (card) that rounding; on the
    CPU the kernel's plain version is 0.016 max and 0.0028 mean from the
    direct conv in latents and 0.020 and 0.0024 in decoded values at this
    config, so the decoded bounds of phases 7 and 17 (0.1 max, 0.01 mean)
    hold latents and images alike."""
    from vqgan_tpu_torch.config import TVAEConfig
    from vqgan_tpu_torch.inference import TVAEPipeline
    from vqgan_tpu_torch.models.tae import init_tvae

    set_tf32(False)
    clips = np.random.RandomState(7).randint(0, 256, (2, 4, 32, 32, 3), np.uint8)
    for dtype in ("float32", "bfloat16"):
        cfg = TVAEConfig(resolution=32, ch=32, ch_mult=ch_mult, num_res_blocks=1,
                         compute_dtype=dtype, attn_chunk=64)
        gen = torch.Generator().manual_seed(21)
        model = init_tvae(cfg, gen)
        with torch.no_grad():  # non-trivial GroupNorm affines
            for name, p in model.named_parameters():
                if p.ndim == 1 and ".norm" in name:
                    p.normal_(1.0 if name.endswith(".weight") else 0.0, 0.2, generator=gen)
        sd = model.state_dict()
        cpu = TVAEPipeline(cfg, sd, device="cpu")
        gpu = TVAEPipeline(cfg, sd, device="cuda")
        cc.launches = ac.fwd_launches = 0
        z_cpu, z_gpu = cpu.encode(clips), gpu.encode(clips).cpu()
        r_cpu, r_gpu = cpu.decode(z_cpu), gpu.decode(z_cpu)
        if (cc.launches, ac.fwd_launches) != (25, 2):
            raise AssertionError(f"{cc.launches} Conv3d and {ac.fwd_launches} attention "
                                 f"launches on the card, expected 25 and 2")
        z_err = (z_cpu.float() - z_gpu.float()).abs()
        r_err = np.abs(r_cpu - r_gpu)
        log(f"tvae cross-device ch=32 {ch_mult} (head_dim {32 * ch_mult[-1] // 8}) 4f/32px "
            f"{dtype}: latents max_abs_err="
            f"{float(z_err.max()):.3e} mean={float(z_err.mean()):.3e} (|z|max "
            f"{float(z_cpu.abs().max()):.3f}); decoded max_abs_err={r_err.max():.3e} "
            f"mean={r_err.mean():.3e}")
        if dtype == "float32":
            ok = float(z_err.max()) <= ATOL_PATH_FP32 and r_err.max() <= ATOL_PATH_FP32
        else:
            ok = all(e.max() <= MAX_TOL_PATH_BF16 and e.mean() <= MEAN_TOL_PATH_BF16
                     for e in (z_err.numpy(), r_err))
        if not ok:
            raise AssertionError(f"TVAE serving differs across devices ({dtype})")


def _probe_library_operands(case, a, b):
    """One (M, K) @ (K, N) product of ``case``'s operands for torch.matmul,
    arranged outside the timing: A, B the fat-N (256,64)@(64,192); C the nine
    chunks side by side; D, E the slabs side by side; F, G the two windows;
    H the 9-window im2col, in bf16."""
    from vqgan_tpu_torch.ops.geometry_probe import BH, CI, K, STRIP_W, WF

    if case.letter in "AB":
        return a, b.reshape(K, -1)
    if case.letter == "C":
        return a.permute(1, 0, 2).reshape(a.shape[1], -1), b.reshape(-1, b.shape[2])
    if case.letter in "DE":
        return torch.cat([a[0], a[1]], 1), b
    if case.letter in "FG":
        return torch.cat([a[:, :STRIP_W - 2].reshape(-1, K), a[:, 2:].reshape(-1, K)], 1), b
    xq = a.to(torch.bfloat16)
    wins = [xq[dh:dh + BH, dw:dw + WF].reshape(BH * WF, CI) for dh in range(3) for dw in range(3)]
    return torch.cat(wins, 1), b.to(torch.bfloat16)


def phase_geometry_probe(gpc) -> tuple[int, dict]:
    """Kernel #7 (phase 22). The main path: the probe's entry point
    (``run_probe``), each case's kernel once, counted; every case must build
    and hold its plain version at the JAX tool's 2e-2. Then each case alone:
    kernel, plain and torch.matmul (the same product, TF32 off; H in bf16)
    times by CUDA events, and the bound (bytes: inputs read once, output
    written once; operations at 67 TFLOP/s fp32, 989 bf16). Returns the
    counted launches and, by letter, (max_abs_err, ms, plain ms, library
    ms, bound ms, bound_by, registers, local bytes), the times the device's
    (CUDA graph replays); the host clock's CUDA-event times are logged
    beside them."""
    from vqgan_tpu_torch.ops.geometry_probe import ATOL, CASES, RTOL, make_inputs
    from vqgan_tpu_torch.tools.probe_conv3d_geometry import run_probe
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    set_tf32(False)
    gpc.launches = 0
    results = run_probe(iters=0, log=log)
    torch.cuda.synchronize()
    counted = gpc.launches
    bad = [r.case.letter for r in results if not (r.built and r.ok)]
    log(f"geometry probe entry point: {counted} kernel launches, not built or wrong: {bad}")
    if counted != len(CASES) or bad:
        raise AssertionError(f"expected all {len(CASES)} cases built, OK and launched once")
    inputs = {k: torch.from_numpy(v).cuda() for k, v in make_inputs().items()}
    out = {}
    for case, res in zip(CASES, results):
        a, b = (inputs[k] for k in case.inputs)
        got, ref = gpc.probe_case(case, a, b), case.plain(a, b)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"geometry probe case {case.letter}: max abs err {err}")
        ms = device_ms(lambda: gpc.probe_case(case, a, b), 100)
        plain_ms = device_ms(lambda: case.plain(a, b), 100)
        lhs, rhs = _probe_library_operands(case, a, b)
        lib_ms = device_ms(lambda: torch.matmul(lhs, rhs), 100)
        host_ms = cuda_ms(lambda: gpc.probe_case(case, a, b))
        host_lib_ms = cuda_ms(lambda: torch.matmul(lhs, rhs))
        n_bytes = 4 * (a.numel() + b.numel() + got.numel())
        peak = BF16_FLOPS_PER_S if case.dtype == "bf16" else FP32_FLOPS_PER_S
        by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, case.flops / peak * 1e3
        bound = max(by_bytes, by_ops)
        bound_by = "bytes" if by_bytes >= by_ops else "operations"
        out[case.letter] = (err, ms, plain_ms, lib_ms, bound, bound_by, res.num_regs,
                            res.local_bytes)
        blocks, cluster = gpc.grid(case)
        log(f"geometry probe {case.name}: grid {blocks} blocks"
            + (f" in clusters of {cluster} (K split)" if cluster > 1 else "")
            + f", {res.num_regs} registers, {res.local_bytes} B local, {res.shared_bytes} B "
            f"shared; max_abs_err={err:.3e}; device time (CUDA graph replays of 100 calls): "
            f"kernel {ms * 1e3:.2f} us, torch.matmul {lib_ms * 1e3:.2f} us (kernel/matmul "
            f"{ms / lib_ms:.2f}), plain {plain_ms * 1e3:.2f} us; host clock (CUDA events over "
            f"20 calls from the host): kernel {host_ms * 1e3:.2f} us, torch.matmul "
            f"{host_lib_ms * 1e3:.2f} us; bound {bound * 1e3:.3f} us ({bound_by}; "
            f"{case.flops / 1e6:.1f} MFLOP {case.dtype}, {n_bytes} bytes)")
    return counted, out


def count_step_launches(model) -> tuple[dict, list]:
    """Forward pre-hooks that count what one training step launches from the
    model: kernel #6 at each Conv3d that takes it (``conv3d``) and, where its
    input takes a gradient, its dx in the backward (``conv3d_dx``); a
    GroupNorm forward and backward at each norm (its affine params always
    take a gradient). Returns the dict and the hooks."""
    from vqgan_tpu_torch.models.blocks import FP32GroupNorm
    from vqgan_tpu_torch.models.tae import Conv3d

    seen = {"conv3d": 0, "conv3d_dx": 0, "gn": 0, "gn_bwd": 0}

    def conv(module, args):
        if module.uses_kernel(args[0]):
            seen["conv3d"] += 1
            seen["conv3d_dx"] += int(args[0].requires_grad)

    def norm(module, args):
        seen["gn"] += 1
        seen["gn_bwd"] += 1

    hooks = [m.register_forward_pre_hook(conv if isinstance(m, Conv3d) else norm)
             for m in model.modules() if isinstance(m, (Conv3d, FP32GroupNorm))]
    return seen, hooks


def phase_train3d(gn, cc, gan: bool = False, disc_3d: str = "frame") -> dict:
    """The 3D recon-only step (phase 23) or GAN step (phase 24) at the bench
    config (``profile_step.build_step3d``: hinge + LeCam, 4 of the 16 frames
    to LPIPS and D, fp32 LPIPS and D). Recon-only: the loss falls over 5 steps on one clip batch; GAN: D
    moves in step 1 and G in step 2 (its lr is 0 at step 0). Then one counted
    step (exact launches: STEP3D_LAUNCHES, from the wrappers and from the
    model's hooks) and 5 timed steps after those warm-ups, host clock, ending
    in a fetch of the loss: frames/s, ms per step, peak memory."""
    from vqgan_tpu_torch.tools.profile_step import build_step3d

    set_tf32(True)
    what = f"train3d {'gan ' + disc_3d if gan else 'recon-only'}"
    t0 = time.perf_counter()
    # recon-only: an lr that moves the loss within 5 steps (the bench's
    # default is 1e-5 / 64); the speed of a step does not depend on it
    state, step, model, disc, src = build_step3d(
        STEP3D_BATCH, STEP3D_FRAMES, STEP3D_RES, disc_3d if gan else "none",
        learning_rate_vae=None if gan else 0.032)
    batches = [next(src) for _ in range(7)]
    log(f"{what}: {sum(p.numel() for p in model.parameters())} G params"
        + (f", {sum(p.numel() for p in disc.parameters())} D params" if gan else "")
        + f", clips {tuple(batches[0].shape)}, build {time.perf_counter() - t0:.1f} s")
    key = "overall_vae_loss" if gan else "loss"
    if gan:
        def snap(m):
            return [p.detach().clone() for p in m.parameters()]

        def moved(m, before):
            return any(not torch.equal(p, q) for p, q in zip(m.parameters(), before))

        g0, d0 = snap(model), snap(disc)
        state, metrics = step(state, batches[0])
        if moved(model, g0) or not moved(disc, d0):
            raise AssertionError("expected D to move in step 1 and G not (its lr is 0)")
        for _ in range(2):
            state, metrics = step(state, batches[0])
        if not moved(model, g0):
            raise AssertionError("G did not move in step 2")
        del g0, d0
        log(f"{what}: D moved in step 1, G in step 2")
    else:
        losses = []
        for _ in range(5):
            state, metrics = step(state, batches[0])
            losses.append(float(metrics["loss"]))
        log(f"{what}: loss over 5 steps on one batch: " + ", ".join(f"{v:.5f}" for v in losses))
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError("the recon-only loss did not fall over 5 steps")

    # the main path, counted: one training step
    seen, hooks = count_step_launches(model)
    gn_shapes, gn_hooks = record_gn_shapes(model)
    cc.launches = cc.bwd_launches = cc.tc_launches = cc.fma_launches = 0
    gn.launches = gn.bwd_launches = 0
    state, metrics = step(state, batches[1])
    torch.cuda.synchronize()
    for h in hooks + gn_hooks:
        h.remove()
    counts = {"conv3d": cc.launches, "conv3d_dx": cc.bwd_launches, "gn": gn.launches,
              "gn_bwd": gn.bwd_launches}
    log(f"{what}: kernel launches per step {counts}, from the model's hooks {seen}")
    if counts != STEP3D_LAUNCHES or seen != STEP3D_LAUNCHES:
        raise AssertionError(f"expected {STEP3D_LAUNCHES} launches per step")
    check_tc_route(cc, what)

    iters = 5
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(iters):
        state, metrics = step(state, batches[2 + i])
    float(metrics[key])  # waits for the device
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    values = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in values.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    log(f"{what} metrics: " + ", ".join(f"{k}={v:.5g}" for k, v in sorted(values.items())))
    frames = STEP3D_BATCH * STEP3D_FRAMES * iters
    result = {"frames_per_s": frames / seconds, "step_ms": seconds / iters * 1e3,
              "peak_bytes": peak, "counts": counts, "gn_shapes": gn_shapes}
    log(f"{what} 16f/128px batch {STEP3D_BATCH}: {result['frames_per_s']:.3f} frames/s, "
        f"{result['step_ms']:.1f} ms per step (host clock over {iters} steps), peak memory "
        f"{peak / 2**30:.3f} GiB")
    del state, step, model, disc, batches, metrics
    torch.cuda.empty_cache()
    return result


def phase_train3d_cross_device(cc, ac, gn, vq: bool, ch_mult=(1, 8)) -> None:
    """One 3D GAN step on the CPU and on the card (phase 25): ch=32,
    ``ch_mult`` 1,8 (or 1,4), 1 res block, 4 frames x 32 px, attn_chunk 64
    (512 mid-block tokens of 256 channels, 8 heads of 32; or of 128, 8 heads
    of 16), fp32, TF32 off; 3 of the 4 frames to LPIPS and D; the same
    weights, clips and draws (ε, frame phase, revival rows). Gaussian + frame
    disc, or VQ (K = 1024, EMA 0.9, revival at 0.5) + tubelet disc. The card
    must run kernels #6 (forward and dx), #1/#2 and #3 (forward and backward
    at head_dim 32 or 16); losses and gradients within phase 8's bounds, the
    VQ statistics to one token."""
    from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
    from vqgan_tpu_torch.losses.discriminator import (
        PatchDiscriminator,
        TemporalMix,
        TubeletDiscriminator,
        init_discriminator_,
    )
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.tae import TVAE, init_tvae
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step3d import Step3DDraws, make_train_step_3d_gan

    set_tf32(False)
    k, z = 1024, 16
    extra = dict(reg_type="vq", vq_codebook_size=k, vq_ema_decay=0.9,
                 vq_revive_threshold=0.5) if vq else {}
    tvae_cfg = TVAEConfig(resolution=32, ch=32, ch_mult=ch_mult, num_res_blocks=1, z_channels=z,
                          compute_dtype="float32", attn_chunk=64, **extra)
    disc_3d = "tubelet" if vq else "frame"
    cfg = TrainConfig(batch_size=2, image_size=32, max_steps=10_000, do_ganloss=True,
                      disc_type="hinge", use_lecam=True, video_loss_frames=3, disc_3d=disc_3d,
                      learning_rate_disc=1e-8)
    gen = torch.Generator().manual_seed(25)
    model = init_tvae(tvae_cfg, gen)
    with torch.no_grad():  # non-trivial GroupNorm affines
        for name, p in model.named_parameters():
            if p.ndim == 1 and ".norm" in name:
                p.normal_(1.0 if name.endswith(".weight") else 0.0, 0.2, generator=gen)
    sd_model = model.state_dict()
    disc_ref = TubeletDiscriminator(3) if vq else PatchDiscriminator()
    init_discriminator_(disc_ref, gen)
    with torch.no_grad():  # non-zero final heads, and temporal mixers off the identity
        for i in range(1, 6):
            getattr(disc_ref, f"binary_classifier{i}")[-1].weight.normal_(0.0, 0.05,
                                                                          generator=gen)
        for m in disc_ref.modules():
            if isinstance(m, TemporalMix):
                m.weight.add_(torch.randn(m.weight.shape, generator=gen), alpha=0.2)
    lpips_ref = LPIPS()
    init_lpips_(lpips_ref, gen)
    rng = np.random.RandomState(25)
    clips = rng.uniform(-1, 1, (2, 4, 32, 32, 3)).astype(np.float32)
    eps = torch.from_numpy(rng.randn(2, 2, 16, 16, z).astype(np.float32))
    vq_ema = revive_idx = None
    if vq:
        sd_model["reg.codebook"] = torch.from_numpy((0.5 * rng.randn(k, z)).astype(np.float32))
        revive_idx = torch.from_numpy(rng.randint(0, 2 * 2 * 16 * 16, k))
        counts = torch.from_numpy(rng.uniform(0.3, 1.3, k).astype(np.float32))
        vq_ema = {"counts": counts, "sums": counts[:, None] * sd_model["reg.codebook"]}
    runs, tape = {}, DecisionTape()
    for run in ("cpu", "cuda", "cuda free"):
        dev = run.split()[0]
        with torch.device(dev):
            model = TVAE(tvae_cfg)
            disc = TubeletDiscriminator(3) if vq else PatchDiscriminator()
            lpips = LPIPS()
        model.load_state_dict(sd_model, strict=True)
        disc.load_state_dict(disc_ref.state_dict(), strict=True)
        lpips.load_state_dict(lpips_ref.state_dict(), strict=True)
        state = create_train_state(cfg, model, disc, tvae_cfg.ch, vq_ema=vq_ema)
        step = make_train_step_3d_gan(cfg, tvae_cfg, model, disc, lpips)
        draws = Step3DDraws(eps=None if vq else eps.to(dev),
                            frame_u=torch.tensor(0.37, device=dev),
                            revive_idx=None if revive_idx is None else revive_idx.to(dev))
        cc.launches = cc.bwd_launches = ac.fwd_launches = ac.bwd_launches = 0
        gn.launches = gn.bwd_launches = 0
        head = {"lpips": lpips, "disc": disc}
        with (tape.recording(head) if run == "cpu" else
              tape.replaying(head) if run == "cuda" else contextlib.nullcontext()):
            state, metrics = step(state, torch.from_numpy(clips).to(dev), draws)
        launches = (cc.launches, cc.bwd_launches, gn.launches, gn.bwd_launches,
                    ac.fwd_launches, ac.bwd_launches)
        if dev == "cuda":
            torch.cuda.synchronize()
            log(f"train3d cross-device card launches (Conv3d, dx, GN, GN bwd, attention, "
                f"attention bwd): {launches}")
            # 10 encoder + 15 decoder convs, 10 + 14 GroupNorms, one
            # AttnBlock3D in each
            if launches != (25, 24, 24, 24, 2, 2):
                raise AssertionError("expected (25, 24, 24, 24, 2, 2) launches on the card")
        moments = {side: {n: opt.state[p]["exp_avg"].cpu() for n, p in m.named_parameters()
                          if p in opt.state}
                   for side, m, opt in (("G", model, state.g_opt), ("D", disc, state.d_opt))}
        extra_out = {}
        if vq:
            extra_out = {"counts": state.vq_ema["counts"].cpu(),
                         "sums": state.vq_ema["sums"].cpu(),
                         "codebook": model.reg.codebook.detach().cpu()}
        runs[run] = ({name: float(v) for name, v in metrics.items()}, moments, extra_out)
    log(f"train3d cross-device: {tape.describe()} recorded on the CPU, replayed on the card")
    # real and fake logits: 2 clips x 3 frames x a 2x2 patch grid at 32 px
    compare_step_across_devices(
        runs, f"3D {'vq K=1024 + tubelet' if vq else 'gaussian + frame'} ch=32 {ch_mult} "
        f"(head_dim {32 * ch_mult[-1] // 8}) 4f/32px",
        2 * 2 * 3 * 4, k if vq else 0)

class JobProbe:
    """Instruments the port's ``Trainer`` for one call of the CLI: each
    train step timed by the host clock (to a device sync after it) and by
    CUDA events on the stream, its batch and state checked to lie on the
    card; each eval and save timed; each restore compared, bitwise, with
    the live state that the previous call ended with (and saved), so a save
    that wrote a wrong tensor or generator state fails too. ``expect`` holds
    that state's ``device_tree``, one item; the restore takes it out, so its
    memory is free before the job trains. Patches the trainer module's
    ``make_train_step`` and the classes' methods while active; a timing or
    check adds a sync to the run, no work."""

    def __init__(self, expect: list[dict] | None = None):
        self.expect = expect or []
        self.steps, self.evals, self.saves, self.restores = [], [], [], []

    @contextlib.contextmanager
    def active(self):
        from vqgan_tpu_torch.train import checkpoint as ckpt_mod
        from vqgan_tpu_torch.train import trainer as trainer_mod

        probe = self
        real_make = trainer_mod.make_train_step
        real_eval, real_save = trainer_mod.Trainer.evaluate, trainer_mod.Trainer.save
        real_restore = ckpt_mod.CheckpointManager.restore

        def make(*args, **kw):
            step = real_make(*args, **kw)

            def timed(state, batch, do_crop=0, draws=None):
                if batch.device.type != "cuda":
                    raise AssertionError(f"the job's batch is on {batch.device}")
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                out = step(state, batch, do_crop, draws)
                end.record()
                torch.cuda.synchronize()
                probe.steps.append((time.perf_counter() - t0, start.elapsed_time(end)))
                return out
            return timed

        def timed_method(real, into):
            def method(self, *args):
                t0 = time.perf_counter()
                real(self, *args)
                torch.cuda.synchronize()
                into.append(time.perf_counter() - t0)
            return method

        def restore(self, state, step=None):
            out = real_restore(self, state, step)
            if out is not None:
                if not probe.expect:
                    raise AssertionError("a restore with no live state to hold it against")
                same, n = same_state(device_tree(state), probe.expect.pop())
                probe.restores.append((state.step, same, n))
            return out

        trainer_mod.make_train_step = make
        trainer_mod.Trainer.evaluate = timed_method(real_eval, self.evals)
        trainer_mod.Trainer.save = timed_method(real_save, self.saves)
        ckpt_mod.CheckpointManager.restore = restore
        try:
            yield self
        finally:
            trainer_mod.make_train_step = real_make
            trainer_mod.Trainer.evaluate, trainer_mod.Trainer.save = real_eval, real_save
            ckpt_mod.CheckpointManager.restore = real_restore


def device_tree(state) -> dict:
    """``state_dict_of``'s tree of a train state with every tensor cloned
    where it lies (on the card; the generator's state on the host): the
    live state to hold a restore against, with no copy to the host."""
    from vqgan_tpu_torch.train import checkpoint as ckpt_mod

    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(clone(v) for v in tree)
        return tree

    real, ckpt_mod._cpu = ckpt_mod._cpu, clone
    try:
        return ckpt_mod.state_dict_of(state)
    finally:
        ckpt_mod._cpu = real


def same_state(a, b) -> tuple[bool, int]:
    """Whether every tensor of two ``state_dict_of`` trees is bitwise equal
    (dtype, shape and values), and how many tensors they hold. Numbers are
    not compared: a resumed run's schedule sets its own lrs."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b)), 1
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return False, 0
        results = [same_state(a[k], b[k]) for k in a]
    elif isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return False, 0
        results = [same_state(x, y) for x, y in zip(a, b)]
    else:
        return True, 0
    return all(r[0] for r in results), sum(r[1] for r in results)


def check_on_card(trainer) -> int:
    """Every parameter and AdamW moment of the job's models, the LeCam
    anchors, the EMA statistics and the step's generator on the card;
    returns the number of tensors checked."""
    st = trainer.state
    tensors = [p for m in (trainer.vae, trainer.disc, trainer.lpips) if m is not None
               for p in m.parameters()]
    for opt in (st.g_opt, st.d_opt):
        for per_param in opt.state.values():
            tensors += [per_param["exp_avg"], per_param["exp_avg_sq"]]
    tensors += [st.lecam_real, st.lecam_fake] + list((st.vq_ema or {}).values())
    off = [t.device for t in tensors if t.device.type != "cuda"]
    if off or st.generator.device.type != "cuda":
        raise AssertionError(f"{len(off)} state tensors off the card: {off[:3]}; "
                             f"generator on {st.generator.device}")
    return len(tensors)


def job_lines(run_dir: str, run: str) -> list[dict]:
    with open(os.path.join(run_dir, f"metrics_{run}.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_job_log(lines: list[dict], steps: range, eval_steps: list[int], what: str) -> dict:
    """The steps' losses logged and finite, the evals' four metrics finite
    (SSIM in [-1, 1]) at ``eval_steps``, no eval/metrics_failed anywhere;
    returns the last step's line."""
    if any("eval/metrics_failed" in ln for ln in lines):
        raise AssertionError(f"{what}: eval/metrics_failed in the JSONL")
    losses = {ln["step"]: ln for ln in lines if "overall_vae_loss" in ln}
    if sorted(s for s in losses if s in steps) != list(steps):
        raise AssertionError(f"{what}: logged steps {sorted(losses)}, expected {list(steps)}")
    bad = [(s, k) for s in steps for k, v in losses[s].items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite logged losses {bad[:5]}")
    evals = {ln["step"]: ln for ln in lines if "eval/lpips" in ln}
    if sorted(s for s in evals if s in eval_steps) != eval_steps:
        raise AssertionError(f"{what}: eval lines at {sorted(evals)}, expected {eval_steps}")
    for s in eval_steps:
        vals = [evals[s].get(k) for k in JOB_EVAL_KEYS]
        if any(v is None or not np.isfinite(v) for v in vals) or not -1 <= vals[3] <= 1:
            raise AssertionError(f"{what}: eval line at step {s}: {evals[s]}")
        log(f"{what}: eval at step {s}: " + ", ".join(
            f"{k}={v:.5g}" for k, v in zip(JOB_EVAL_KEYS, vals)))
    return losses[steps[-1]]


def job_wall(lines: list[dict], steps: range, eval_steps: list[int], what: str) -> dict:
    """The job's own clock, from its JSONL: ``time_taken_till_load`` (the
    wait for the batch, the loader's share) and ``time_taken_till_step``
    (the step and its logging) of each step after the first of the call
    whose wait holds no eval and save, and their sum, the job's wall time a
    step."""
    clean = [s for s in steps[1:] if s not in eval_steps]
    losses = {ln["step"]: ln for ln in lines if "overall_vae_loss" in ln}
    load = [losses[s]["time_taken_till_load"] * 1e3 for s in clean]
    step = [losses[s]["time_taken_till_step"] * 1e3 for s in clean]
    out = {"load_ms": float(np.mean(load)), "till_step_ms": float(np.mean(step)),
           "wall_ms": float(np.mean(load) + np.mean(step)), "clean_steps": clean}
    log(f"{what}: the job's wall time a step by its JSONL, steps {clean}: "
        f"{out['wall_ms']:.1f} ms = {out['load_ms']:.1f} ms waiting for the batch "
        f"(time_taken_till_load) + {out['till_step_ms']:.1f} ms the step and its log line "
        f"(time_taken_till_step); per step: " + ", ".join(
            f"{s}: {a:.1f} + {b:.1f}" for s, a, b in zip(clean, load, step)))
    return out


def job_timing(probe: JobProbe, what: str) -> dict:
    """ms per step by the host clock and by CUDA events, over the steps
    after the first of the call (the first builds cuDNN's plans)."""
    later = probe.steps[1:] or probe.steps
    host = float(np.mean([h for h, _ in later])) * 1e3
    dev = float(np.mean([d for _, d in later]))
    out = {"step_ms": host, "device_step_ms": dev, "eval_s": list(probe.evals),
           "save_s": list(probe.saves), "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"{what}: {len(probe.steps)} steps, {host:.1f} ms per step by the host clock (to a "
        f"sync after each; steps 2-{len(probe.steps)}), {dev:.1f} ms between CUDA events; "
        f"first step {probe.steps[0][0] * 1e3:.1f} ms; eval "
        f"{', '.join(f'{t:.2f}' for t in probe.evals)} s; save (the state's host copy; the .pt "
        f"and the state's file are written in the background) "
        f"{', '.join(f'{t:.2f}' for t in probe.saves)} s; peak memory "
        f"{out['peak_bytes'] / 2**30:.3f} GiB")
    return out


def run_job(argv: list[str], what: str,
            expect: list[dict] | None = None) -> tuple[object, JobProbe, float]:
    from vqgan_tpu_torch import cli

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with JobProbe(expect).active() as probe:
        trainer = cli.main(argv)
    seconds = time.perf_counter() - t0
    log(f"{what}: cli.main returned in {seconds:.1f} s")
    return trainer, probe, seconds


def phase_train_job(gn, tmp: str) -> dict:
    """Phase 26: the Gaussian job, then its resume."""
    import shutil

    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.data.tar_stream import image_decoders
    from vqgan_tpu_torch.inference import VAEPipeline

    set_tf32(True)
    what = "train job gaussian"
    try:
        decoders = " then ".join(image_decoders())
    except RuntimeError:
        decoders = "none (the tar readers raise; synthetic data needs none)"
    log(f"{what}: image decoders here: {decoders}")
    argv = TRAIN_JOB + ["--reg_type", "gaussian", "--ckpt_dir", tmp, "--run_name", "g"]
    run_dir = os.path.join(tmp, "g")
    n, steps = 3, 6
    evals = [s for s in range(1, steps + 1) if s % n == 1]  # after steps 1 and 4
    gn.launches = gn.bwd_launches = 0
    trainer, probe, seconds = run_job(argv + ["--max_steps", str(steps)], what)
    counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches}
    want = {"gn": steps * JOB_GN + len(evals) * JOB_GN, "gn_bwd": steps * JOB_GN}
    log(f"{what}: GroupNorm launches {counts}; expected {want}: {steps} steps x "
        f"({JOB_GN} + {JOB_GN}) "
        f"and {JOB_GN} forward for each eval (encode 21 + decode 29) after steps {evals}")
    if counts != want:
        raise AssertionError(f"{what}: GroupNorm launches {counts}, expected {want}")
    n_tensors = check_on_card(trainer)
    lines = job_lines(run_dir, "g")
    last = check_job_log(lines, range(steps), evals, what)
    log(f"{what}: {n_tensors} state tensors on the card; last step's losses: " + ", ".join(
        f"{k}={last[k]:.5g}" for k in ("overall_vae_loss", "perceptual_loss", "kl_loss",
                                       "gan/discriminator_loss", "gan/generator_gan_loss")))
    pt = os.path.join(run_dir, f"vae_epoch_final_step_{steps}.pt")
    full = trainer.ckpt.path(steps)
    for path in [pt, full] + [os.path.join(run_dir, f"vae_epoch_0_step_{s}.pt") for s in evals]:
        if not os.path.isfile(path):
            raise AssertionError(f"{what}: {path} was not written")
    log(f"{what}: checkpoints {trainer.ckpt.steps()} ({os.path.getsize(full) / 2**30:.3f} GiB "
        f"each), .pt {os.path.getsize(pt) / 2**30:.3f} GiB; disk free "
        f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB")
    timing = job_timing(probe, what)
    timing.update(job_wall(lines, range(steps), evals, what))
    # the live state the call ended with, which its final save wrote: the
    # resume's restore is held against it
    live = [device_tree(trainer.state)]
    del trainer
    torch.cuda.empty_cache()

    pipe = VAEPipeline.from_checkpoint(pt, VAEConfig(reg_type="gaussian"), device="cuda")
    images = np.random.RandomState(0).randint(0, 256, (2, 256, 256, 3), np.uint8)
    recon = pipe.reconstruct(images)
    if recon.shape != (2, 256, 256, 3) or not np.isfinite(recon).all() \
            or recon.min() < 0 or recon.max() > 1:
        raise AssertionError(f"{what}: the .pt's reconstruction {recon.shape} "
                             f"[{recon.min()}, {recon.max()}]")
    log(f"{what}: {os.path.basename(pt)} served by VAEPipeline: 2 images in "
        f"[{recon.min():.4f}, {recon.max():.4f}]")
    del pipe
    # the resume reads the latest full state alone: drop the older files
    for s in evals:
        os.remove(os.path.join(run_dir, f"vae_epoch_0_step_{s}.pt"))
        os.remove(os.path.join(run_dir, "state", f"step_{s:08d}.pt"))

    what = "train job gaussian resume"
    gn.launches = gn.bwd_launches = 0
    trainer, probe, _ = run_job(argv + ["--max_steps", "8"], what, live)
    if [(s, ok) for s, ok, _ in probe.restores] != [(steps, True)]:
        raise AssertionError(f"{what}: restores {probe.restores}, expected step {steps} bitwise")
    log(f"{what}: restored step {steps}: all {probe.restores[0][2]} tensors of the state, the "
        f"generator's state included, bitwise those the first call ended with")
    counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches}
    if counts != {"gn": 3 * JOB_GN, "gn_bwd": 2 * JOB_GN}:
        raise AssertionError(f"{what}: GroupNorm launches {counts}, expected {3 * JOB_GN} and "
                             f"{2 * JOB_GN} (2 steps, the eval after step 7)")
    check_on_card(trainer)
    check_job_log(job_lines(run_dir, "g"), range(steps, 8), [7], what)
    if trainer.state.step != 8:
        raise AssertionError(f"{what}: ended at step {trainer.state.step}")
    timing["resume_step_ms"] = job_timing(probe, what)["step_ms"]
    timing["seconds"] = seconds
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)
    return timing


def phase_train_job_vq(gn, vq, tmp: str) -> dict:
    """Phase 27: the VQ job for 3 steps, then a restore of its state."""
    import shutil

    from vqgan_tpu_torch import cli
    from vqgan_tpu_torch.train.trainer import Trainer

    set_tf32(True)
    what = "train job vq"
    argv = TRAIN_JOB + ["--reg_type", "vq", "--ckpt_dir", tmp, "--run_name", "v",
                        "--max_steps", "3"]
    gn.launches = gn.bwd_launches = vq.nearest_launches = vq.stats_launches = 0
    trainer, probe, _ = run_job(argv, what)
    counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches, "nearest": vq.nearest_launches,
              "stats": vq.stats_launches}
    want = {"gn": 4 * JOB_GN, "gn_bwd": 3 * JOB_GN, "nearest": 3 + 1, "stats": 3}
    log(f"{what}: launches {counts}; expected {want}: 1 search and 1 statistics a step, 1 "
        f"search for the eval after step 1")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    check_on_card(trainer)
    lines = job_lines(os.path.join(tmp, "v"), "v")
    check_job_log(lines, range(3), [1], what)
    timing = job_timing(probe, what)
    timing.update(job_wall(lines, range(3), [1], what))
    live = [device_tree(trainer.state)]
    del trainer
    torch.cuda.empty_cache()
    with JobProbe(live).active() as probe:
        kw = vars(cli.build_parser().parse_args(argv))
        cfg, vae_cfg = cli.configs(kw)
        trainer = Trainer(cfg, vae_cfg, device=kw["device"])
    if [(s, ok) for s, ok, _ in probe.restores] != [(3, True)] or trainer.state.vq_ema is None:
        raise AssertionError(f"{what}: restores {probe.restores}, expected step 3 bitwise")
    log(f"{what}: restored step 3: all {probe.restores[0][2]} tensors bitwise those the job "
        f"ended with, "
        f"vq_ema (counts {tuple(trainer.state.vq_ema['counts'].shape)}, sums "
        f"{tuple(trainer.state.vq_ema['sums'].shape)}) among them")
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "v"))
    return timing


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs "
              "a CUDA device", file=sys.stderr)
        return 1
    t_smoke = time.perf_counter()

    from vqgan_tpu_torch.ops import attention_cuda as ac
    from vqgan_tpu_torch.ops import conv3d_cuda as cc
    from vqgan_tpu_torch.ops import cuda_build
    from vqgan_tpu_torch.ops import geometry_probe_cuda as gpc
    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.ops import vq_cuda as vq
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32, group_norm_fp32_backward

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    set_tf32(False)

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    modules = (gn, vq, ac, cc, gpc)
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        for lib in [pool.submit(m.library) for m in modules]:
            lib.result()
    names = ", ".join(cuda_build.library_path(n).name
                      for n in ("groupnorm", "vq", "attention", "conv3d", "geometry_probe"))
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s ({names})")

    # 3. forward kernel vs plain; 4. backward kernel vs plain
    fwd = {b: phase_kernel_vs_plain(gn, group_norm_fp32, b) for b in (2, SERVE_BATCH)}
    bwd = phase_backward_vs_plain(gn, group_norm_fp32_backward, TRAIN_BATCH)

    # 5. flagship serving path
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches, flagship = phase_flagship(gn, tmp)

    # 6. flagship training step
    train_counts, train = phase_train_flagship(gn)

    # 7. serving, CPU vs card; 8. training, CPU vs card
    phase_cross_device()
    phase_train_cross_device()

    # 9. the VQ kernels vs plain
    vq_nearest, vq_stats = phase_vq_kernels(vq)

    # 10. VQ serving; 11. the VQ training step, both at the flagship width
    with tempfile.TemporaryDirectory() as tmp:
        _, vq_serve = phase_vq_serving(gn, vq, tmp)
    vq_counts, vq_train = phase_train_vq_flagship(gn, vq)

    # 12. VQ, CPU vs card: serving, then a training step
    phase_vq_cross_device()
    phase_train_cross_device(vq_k=VQ_CROSS_K)

    # 13. the attention kernels vs plain
    attn = phase_attention_kernels(ac)

    # 14. attention serving at the flagship width; 15. at 1,024 px
    with tempfile.TemporaryDirectory() as tmp:
        attn_serve_counts, attn_serve, hires = phase_attn_serving(gn, ac, tmp)

    # 16. the flagship training step with attention
    attn_counts, attn_train = phase_train_flagship(gn, ac)

    # 17. attention, CPU vs card: serving, then a training step
    phase_cross_device(attn=True)
    phase_train_cross_device(attn=True)

    # 18. the Conv3d kernel vs plain
    conv_fwd, conv_dx, conv_split = phase_conv3d_kernels(cc)

    # 19. TVAE clip serving at 16f/128px; 20. the long clip at 48f/256px
    with tempfile.TemporaryDirectory() as tmp:
        clip_counts, clip_serve, clip_grad = phase_clip_serving(gn, cc, ac, tmp)
        long_clip = phase_long_clip(gn, cc, ac, tmp)

    # 21. TVAE serving, CPU vs card, at mid-block head_dim 32 and 16
    phase_tvae_cross_device(cc, ac)
    phase_tvae_cross_device(cc, ac, ch_mult=(1, 4))

    # 22. kernel #7: the geometry probe's entry point, then each case vs plain
    probe_counted, probe = phase_geometry_probe(gpc)

    # 23. the 3D recon-only step; 24. the 3D GAN step, frame and tubelet D
    train3d = {"recon-only": phase_train3d(gn, cc)}
    for disc_3d in ("frame", "tubelet"):
        train3d[f"gan {disc_3d}"] = phase_train3d(gn, cc, gan=True, disc_3d=disc_3d)
    # kernels #1 and #2 at every 5-D shape the 3D steps ran (the GAN steps add 2D
    # modules only, so their GroupNorms are the recon-only step's)
    step3d_gn = train3d["recon-only"]["gn_shapes"]
    if any(r["gn_shapes"] != step3d_gn for r in train3d.values()):
        raise AssertionError("the 3D steps ran their GroupNorms at different shapes")
    fwd3d_err = gn_at_clip_shapes(gn, step3d_gn, "3D training step")
    bwd3d_err, bwd3d_step = gn_bwd_at_shapes(gn, step3d_gn, "3D training step")

    # 25. the 3D GAN step, CPU vs card
    phase_train3d_cross_device(cc, ac, gn, vq=False)
    phase_train3d_cross_device(cc, ac, gn, vq=True)
    phase_train3d_cross_device(cc, ac, gn, vq=False, ch_mult=(1, 4))

    # 26. the training job through the CLI, and its resume; 27. the VQ job
    t_job = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job = phase_train_job(gn, tmp)
        t_vq = time.perf_counter()
        job_vq = phase_train_job_vq(gn, vq, tmp)
    t_end = time.perf_counter()
    log(f"phases 26-27 (the training job): {t_end - t_job:.1f} s (26: {t_vq - t_job:.1f} s, "
        f"27: {t_end - t_vq:.1f} s) of the {t_end - t_smoke:.1f} s the smoke has run so far")

    serving = {"enc": torch.float32, "dec": torch.bfloat16}
    training = {"enc": torch.bfloat16, "dec": torch.bfloat16}
    for b, res in fwd.items():
        k, p, lib, bnd = per_step(res, serving)
        log(f"GN forward per flagship reconstruct at batch {b} (fp32 encoder, bf16 decoder): "
            f"kernel {k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound {bnd:.4f} ms")
    fwd_step = per_step(fwd[TRAIN_BATCH], training)
    bwd_step = per_step(bwd, training)
    for name, (k, p, lib, bnd) in (("forward", fwd_step), ("backward", bwd_step)):
        log(f"GN {name} per flagship training step at batch {TRAIN_BATCH} (all bf16): "
            f"kernel {k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound {bnd:.4f} ms")
    log(f"GN forward (kernel #1, device time) per flagship training step: {fwd_step[0]:.4f} ms "
        f"against its {fwd_step[3]:.4f} ms bound ({fwd_step[3] / fwd_step[0]:.3f} of it) and the "
        f"{GN_FWD_TARGET_MS} ms target")
    log(f"GN backward (kernel #2, device time) per flagship training step: {bwd_step[0]:.4f} ms "
        f"against its {bwd_step[3]:.4f} ms bound ({bwd_step[3] / bwd_step[0]:.3f} of it) and the "
        f"{GN_BWD_TARGET_MS} ms target; per 3D training step ({sum(step3d_gn.values())} calls): "
        f"{bwd3d_step[0]:.4f} ms against {bwd3d_step[3]:.4f}")
    log(f"training step device time between CUDA events (host clock beside): identity "
        f"{train['device_step_ms']:.1f} ms ({train['step_ms']:.1f}), VQ "
        f"{vq_train['device_step_ms']:.1f} ms ({vq_train['step_ms']:.1f}), attention "
        f"{attn_train['device_step_ms']:.1f} ms ({attn_train['step_ms']:.1f})")
    log(f"serving batch {SERVE_BATCH}: {flagship['img_per_s']:.3f} img/s, "
        f"{serve_launches} forward launches per reconstruct; training batch {TRAIN_BATCH}: "
        f"{train['img_per_s']:.3f} img/s, {train['step_ms']:.1f} ms per step, peak "
        f"{train['peak_bytes'] / 2**30:.3f} GiB")
    log(f"VQ serving batch {SERVE_BATCH}: {vq_serve['img_per_s']:.3f} img/s, peak "
        f"{vq_serve['peak_bytes'] / 2**30:.3f} GiB; VQ training batch {TRAIN_BATCH}: "
        f"{vq_train['img_per_s']:.3f} img/s, {vq_train['step_ms']:.1f} ms per step, peak "
        f"{vq_train['peak_bytes'] / 2**30:.3f} GiB")
    bf16 = torch.bfloat16
    attn_step = {kind: [2 * x for x in attn[("flagship", bf16, kind)][1:]]
                 for kind in ("fwd", "bwd")}
    log(f"attention serving batch {SERVE_BATCH}: {attn_serve['img_per_s']:.3f} img/s, "
        f"{attn_serve_counts} launches per reconstruct, peak "
        f"{attn_serve['peak_bytes'] / 2**30:.3f} GiB; 1,024 px batch 1: "
        f"{hires['img_per_s']:.3f} img/s, peak {hires['peak_bytes'] / 2**30:.3f} GiB; "
        f"attention training batch {TRAIN_BATCH}: {attn_train['img_per_s']:.3f} img/s, "
        f"{attn_train['step_ms']:.1f} ms per step, peak "
        f"{attn_train['peak_bytes'] / 2**30:.3f} GiB")
    for kind, (k, p, lib, bnd) in attn_step.items():
        log(f"attention {kind} per flagship training step at batch {TRAIN_BATCH} (2 bf16 "
            f"calls): kernel {k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, "
            f"bound {bnd:.4f} ms")
    conv_step = per_reconstruct(conv_fwd, CLIP_BATCH, clip_conv3d_calls())
    dx_step = per_reconstruct(conv_dx, CLIP_BATCH, clip_conv3d_calls(backward=True))
    for name, (k, p, lib, bnd) in (("forward", conv_step), ("dx", dx_step)):
        log(f"Conv3d {name} per 16f/128px reconstruct{' backward' if name == 'dx' else ''} at "
            f"batch {CLIP_BATCH} (bf16, {55 if name == 'forward' else 54} calls): kernel "
            f"{k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound {bnd:.4f} ms")
    calls = clip_conv3d_calls()
    clip_split = {key[1:]: v for key, v in conv_split.items() if key[0] == CLIP_BATCH
                  and key[1:] in calls}
    for i, name in ((1, "forward"), (3, "dx")):
        n = sum(calls[s] for s in clip_split)
        log(f"Conv3d {name} split-K per 16f/128px reconstruct at batch {CLIP_BATCH} (bf16, "
            f"device time of the {n} calls of the {len(clip_split)} shapes whose forward or "
            f"dx splits K): "
            f"{sum(calls[s] * v[i] for s, v in clip_split.items()):.4f} ms split, "
            f"{sum(calls[s] * v[i + 1] for s, v in clip_split.items()):.4f} ms at one split")
    k, p, lib, bnd = per_reconstruct(conv_fwd, 1, LONG_CONV3D_SHAPES)
    log(f"Conv3d forward per 48f/256px reconstruct at batch 1 (bf16, 44 calls): kernel "
        f"{k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound {bnd:.4f} ms")
    step_dx = dict(STEP3D_CONV3D_SHAPES)
    step_dx[(3, 64, STEP3D_FRAMES, STEP3D_RES, STEP3D_RES)] -= 1
    for name, res, n_calls in (("forward", conv_fwd, STEP3D_CONV3D_SHAPES),
                               ("dx", conv_dx, step_dx)):
        k, p, lib, bnd = per_reconstruct(res, STEP3D_BATCH, n_calls)
        log(f"Conv3d {name} per 3D training step at batch {STEP3D_BATCH} (bf16, "
            f"{sum(n_calls.values())} calls): kernel {k:.4f} ms, plain {p:.4f} ms, library "
            f"{lib:.4f} ms, bound {bnd:.4f} ms")
    log(f"TVAE 16f/128px serving batch {CLIP_BATCH}: {clip_serve['frames_per_s']:.3f} frames/s "
        f"({clip_serve['direct_frames_per_s']:.3f} with cuDNN's Conv3d), "
        f"{clip_counts} launches per reconstruct, peak "
        f"{clip_serve['peak_bytes'] / 2**30:.3f} GiB; 48f/256px batch 1: "
        f"{long_clip['frames_per_s']:.3f} frames/s, peak "
        f"{long_clip['peak_bytes'] / 2**30:.3f} GiB")
    for name, r in train3d.items():
        log(f"3D {name} step 16f/128px batch {STEP3D_BATCH}: {r['frames_per_s']:.3f} frames/s, "
            f"{r['step_ms']:.1f} ms per step, peak {r['peak_bytes'] / 2**30:.3f} GiB, "
            f"{r['counts']} launches per step")
    log(f"train job (CLI, flagship width, batch {TRAIN_BATCH}, 512 px images, gaussian, GAN, "
        f"bf16): {job['step_ms']:.1f} ms per step by the host clock, "
        f"{job['device_step_ms']:.1f} ms between CUDA events, {job['wall_ms']:.1f} ms of the "
        f"job's wall time ({job['load_ms']:.1f} waiting for the batch), resumed "
        f"{job['resume_step_ms']:.1f} ms; eval {', '.join(f'{t:.2f}' for t in job['eval_s'])} s; "
        f"save {', '.join(f'{t:.2f}' for t in job['save_s'])} s; peak "
        f"{job['peak_bytes'] / 2**30:.3f} GiB; whole 6-step call {job['seconds']:.1f} s; "
        f"vq job {job_vq['step_ms']:.1f} ms per step ({job_vq['device_step_ms']:.1f} by "
        f"events, {job_vq['wall_ms']:.1f} of wall time), peak "
        f"{job_vq['peak_bytes'] / 2**30:.3f} GiB")
    log(f"geometry probe: {probe_counted} launches in the entry point's run; per case "
        f"(kernel, plain, torch.matmul, bound) ms, device time: " + "; ".join(
            f"{c} {v[1]:.4f}/{v[2]:.4f}/{v[3]:.4f}/{v[4]:.5f}" for c, v in probe.items()))
    log(f"kernels line: GroupNorm launches per identity training step and ms per step at "
        f"batch {TRAIN_BATCH}, bf16, summed over its 50 calls; VQ launches per flagship VQ "
        f"training step and ms of its one call (N={VQ_CASES['flagship b8'][0]}, "
        f"K={VQ_CASES['flagship b8'][1]}; statistics with sums); the search's max_abs_err is "
        f"its largest fp64 distance gap over plain's code, its bound_ms its three TF32 "
        f"products at 495 TFLOP/s (one fp32 product in phase 9's lines); attention "
        f"launches per flagship attention training step and ms per step, its 2 bf16 calls at B=8, N=1024, H=16, "
        f"D=64 (library: scaled_dot_product_attention, forward, and its backward through "
        f"autograd), max_abs_err over every case of phase 13; Conv3d launches per 16f/128px "
        f"TVAE reconstruct (forward) and per backward of its reconstruct loss (dx), ms summed "
        f"over those 55 and 54 bf16 calls at batch 2 (library: F.conv3d and cuDNN's dgrad, "
        f"bf16, channels_last_3d), max_abs_err over every case of phase 18; geometry probe: "
        f"one entry per case, launches in the probe entry point's run, device ms of one call "
        f"(library: torch.matmul of the same product); GroupNorm, VQ and geometry probe "
        f"times from CUDA graph replays")
    log(smi)

    def entry(name, source, replaces, launches, err, times, bound_by):
        k, p, lib, bnd = times
        return {"name": name, "route": "cuda", "source": f"vqgan_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": k, "plain_ms": p, "bound_ms": bnd, "bound_by": bound_by,
                "library_ms": lib}

    probe_entries = [
        entry(f"geometry_probe_{c}", "geometry_probe.cu", "tools/probe_mosaic_geometry.py:52",
              probe_counted // len(probe), v[0], v[1:5], v[5])
        for c, v in probe.items()]

    log(json.dumps({"kernels": [
        entry("fused_group_norm", "groupnorm.cu", "vqgan_tpu/ops/pallas/groupnorm.py:91",
              train_counts["gn"], max([v[0] for res in fwd.values() for v in res.values()]
                                      + [clip_serve["gn_err"], long_clip["gn_err"], fwd3d_err]),
              fwd_step, "bytes"),
        entry("fused_group_norm_bwd", "groupnorm.cu", "vqgan_tpu/ops/pallas/groupnorm.py:194",
              train_counts["gn_bwd"], max([v[0] for v in bwd.values()] + [bwd3d_err]), bwd_step,
              "bytes"),
        entry("nearest_codes", "vq.cu", "vqgan_tpu/ops/pallas/vq.py:113", vq_counts["nearest"],
              max(v[0] for v in vq_nearest.values()), vq_nearest["flagship b8"][1:],
              "operations"),
        entry("code_stats", "vq.cu", "vqgan_tpu/ops/pallas/vq.py:223", vq_counts["stats"],
              max(v[0] for v in vq_stats.values()), vq_stats[("flagship b8", True)][1:],
              "bytes"),
        entry("flash_attention", "attention.cu", "vqgan_tpu/ops/flash_attention.py:90",
              attn_counts["attn"], max(v[0] for key, v in attn.items() if key[2] == "fwd"),
              attn_step["fwd"], "operations"),
        entry("flash_attention_bwd", "attention.cu", "vqgan_tpu/ops/flash_attention.py:90",
              attn_counts["attn_bwd"], max(v[0] for key, v in attn.items() if key[2] == "bwd"),
              attn_step["bwd"], "operations"),
        entry("conv3d_ttap", "conv3d.cu", "vqgan_tpu/ops/pallas/conv3d.py:243",
              clip_counts["conv3d"], max(v[0] for v in conv_fwd.values()), conv_step,
              "operations"),
        entry("conv3d_ttap_dx", "conv3d.cu", "vqgan_tpu/ops/pallas/conv3d.py:316",
              clip_grad["conv3d_dx"], max(v[0] for v in conv_dx.values()), dx_step,
              "operations"),
        *probe_entries,
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
