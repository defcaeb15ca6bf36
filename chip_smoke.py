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

 28. the 3D training job through ``cli.main(["train3d", ...])`` at
     ``TVAEConfig()``'s width (``TRAIN3D_JOB``: ch 64, ch_mult 1,2,4,4, 2 res
     blocks, z 16, bf16, 16 frames x 128 px, batch 2; hinge GAN + LeCam on 4
     of the 16 frames, fp32 LPIPS and frame D, Polyak EMA 0.999, synthetic
     clips, eval every 3), 6 steps: each step's and each eval's launches of
     #6 (forward and dx), #1 and #2 equal the model's hooks
     (``JobWatch``), every Conv3d call on the tensor cores, D moves in
     step 1 and G in step 2, every state tensor on the card, finite losses,
     each eval line with eval/recon_l2, eval/psnr, eval/ssim and eval/lpips,
     no eval/metrics_failed, the frame strips written, full states at steps
     1, 4 and 6; then ``--max_steps 8`` restores step 6 bitwise against the
     live state the first call ended with, reads the synthetic stream at
     seed + 6 first and ends at step 8; ms per step by the host clock and
     CUDA events, the wall time a step and the wait for its batch, eval and
     save seconds, peak memory;
 29. the recon-only VQ job (K = 16,384, EMA 0.99, revival at 0.98) with the
     chunked mid-block attention (``--attn_chunk 256``: 512 tokens, head_dim
     32) on tar shards of uint8 clips the smoke writes (8 .npy and 2 .npz of
     24 frames at 160 x 192, and a test shard), 3 steps and one eval: 1
     search and 1 statistics launch a step and 1 search an eval, the 2 + 2
     attention launches of a step on the tensor cores, the EMA counts moved,
     some but not all codes revived in step 3 and the rest of the codebook
     the fold, the batches from the shards (the readers' decoder lines), the
     decode workers stopped when the job ends; then kernels #1, #2 and #6
     against their plain versions at every shape phases 28-29 ran them that
     phases 18 and 23 did not (``kernels_at_job_shapes``); #3, #4 and #5 at
     the jobs' shapes are the "3D job" cases of phases 13 and 9;
 30. the native image decoder (``data/native``): built or not (where not,
     the compiler's first error line and the 2D loader's decoder); a PNG
     through ``native_pipeline`` bitwise the crop and the normalization of
     its cv2 decode, ``native_probe``'s size, None for garbage; the train
     transform's images/s on one thread at 512 px, native beside cv2
     (``vqgan_tpu_torch/tools/decode_rate.py``; cv2 alone where not built);
 31. the HDR recipe's job through ``cli.main`` at its own flags
     (``TRAIN_HDR_JOB``: ``tools/launch_hdr.sh``'s flag list, ch 128,
     ch_mult 1,2,4,4,4, z 64, the wavelet encoder at 256 px and the HR
     decoder to 512 px, batch 32, hinge + LeCam, clamp 8, flip and crop
     invariance; plus synthetic 512 px images, ``--grad_accum 4`` (4
     microbatches of 8), 4 steps, an eval every 2, no wandb): each step's and each
     eval's #1 and #2 launches equal the model's hooks (``JobWatch``: every
     GroupNorm call, D's pass's forwards included, and a backward where the
     backward reaches the call's output), D moves in step 1 and G in step
     2, finite losses and eval lines, the .pt served by ``VAEPipeline`` (256
     px in, 512 px out, finite, in [0, 1]), then ``--max_steps 5`` restores
     step 4 bitwise and runs a step and an eval; ms a step by the host clock
     and CUDA events, the job's wall time a step, eval and save seconds,
     peak memory, the card's name and power limit;
 32. remat and accumulation at the recipe's width: one step at a
     microbatch of 8 from one state with remat off, "full" and "conv":
     losses and G's and D's first moments within phase 8's bounds of the
     step without remat, each recomputed GroupNorm call's output equal to
     its forward's (fp64 sums), peak memory full < conv < off, ms of each;
     then the job with ``--grad_accum 2 --remat true`` (microbatches of 16)
     for 2 steps, its launches against the hooks, ms and peak memory;
 33. the 3D GAN job at ``TVAEConfig()``'s width (phase 28's flags) with
     ``--reg_type vq --grad_accum 2 --remat true`` (``TRAIN3D_ACCUM``), 3
     steps and a resume to 4 (bitwise restore): #6, #1, #2 and #4 against the
     hooks, #4 2 x 2 and #5 exactly 2 launches a step (D's pass quantizes
     without statistics), every Conv3d on the tensor cores, D moves in step
     1 and G in step 2, the EMA counts moved; ms and peak memory;
 34. the microbatched step with the HDR recipe's features on the CPU and on
     the card (phase 8's reduced width with the wavelet encoder, the HR
     decoder, crop bucket 1, the heatmap-masked L1, 96 px images for a 64
     px encoder and a 128 px target, batch 4 in 2 microbatches, remat on
     both devices, the decisions of LPIPS and D, recomputed calls included,
     recorded on the CPU and replayed on the card): losses and gradients
     within phase 8's bounds. Then kernels #1, #2 and #6 against their plain
     versions at every shape the jobs of phases 28-29 and 31-33 ran that
     earlier phases did not (``kernels_at_job_shapes``), the HDR decoder's
     512 px level at microbatches of 8 and 16 and the eval's batch of 32
     among them. Phase 32 also prints, for each remat mode, what is live at a
     step's peak by the port's allocating line (``peak_by_line``); phase 31
     holds the nearest upsample at the eval's 2^31 outputs row by row;
 35. the flagship 2D serving artifacts (``vqgan_tpu_torch.export``): phase
     5's identity model's .pt exported by the CLI in a subprocess, and a
     flagship VQ model (phase 10's K) with the mid-block attention (phase
     14's chunk) by ``export_vae`` in process; each loaded by
     ``ExportedVAE.load`` and called at batches 8, 1 and 3: encode, decode
     and reconstruct within 1e-6 of ``VAEPipeline`` on the same weights and
     inputs, and a reconstruct's launches of #1, #3 and #4 equal to the
     pipeline's (50; 52, 2 and 1); export seconds, img/s of the artifact and
     of the pipeline at batch 8 by the host clock and CUDA events, peak
     memory;
 36. the TVAE artifact at ``TVAEConfig()``'s width, 16f/128px, batch 2 (and
     1): within 1e-6 of ``TVAEPipeline`` at ``conv3d_impl="direct"``, which
     the export pins, #1's 52 launches as the pipeline's, none of #6;
     frames/s of the artifact, the direct pipeline and the "auto" one;
 37. portability: a 2D VQ + attention artifact at phase 12's reduced width
     and a TVAE artifact at phase 21's, traced on the card and run on the
     CPU, within phase 21's bounds of the CPU pipelines; traced on the CPU
     and run on the card, the kernels launched as the card's pipeline
     launches them (#1, #3, #4; #1, #3), within the same bounds of it;
 38-41. data parallelism (``parallel/mesh.py``): the flagship, flagship VQ
     and 3D GAN steps at two ranks on the card over gloo against one rank
     on the global batch, and the flagship job under torchrun, and at one
     rank over NCCL against one plain process (``phase_data_parallel_steps``,
     ``phase_data_parallel_jobs``); the ranks also run the flagship step at
     ``grad_accum`` 2 and take each step's state digest for phase 42;
 42. the same ranks, after each case's whole run, with the train state
     sharded over ``fsdp`` (``parallel/fsdp.py``): each step's gathered
     state bitwise the whole run's (or, where it is not, within phase 8's
     bounds, with each rank's allocator OOMs printed), their launches,
     each rank's memory between steps against the rule's saving, peaks and
     the gathers' MiB and ms (``phase_fsdp_steps``);
 43. the flagship job at ``data=1,fsdp=2`` under torchrun (in phase 41's
     launch; 3 steps, eval and saves by rank 0), its save resumed at
     ``data=2`` under torchrun and in one process, each restore bitwise the
     live sharded state (its digest);
 44. the tools (``vqgan_tpu_torch/tools``): one ``adjust_weight_init``
     iteration at ``VAEConfig()``, ``make_alt_lpips``, and
     ``recompute_eval_metrics`` over phase 43's two ``.pt`` files with the
     default and the alternate judge: rows finite, judges >= 0.
 45. ring attention (``ops/ring_attention.py``) over two context ranks
     sharing the card over gloo, at the long clip's and TVAEConfig()'s
     16f/128px mid blocks, forward and backward, against one rank's kernel
     #3 over the whole sequence within ``rounding_bounds``; the ring's
     launch (#3 with fp32 outputs) at its block against its plain version
     and timed, and at the flagship's 2D mid block (phases 45-51: one
     torchrun launch, ``--ctx-ranks``);
 46. kernels #1 and #2 in their two-pass form (sums, apply; backward sums,
     dx) against their plain versions and the one-launch kernels at the
     GroupNorm shapes a context rank's steps ran in phases 47 (fp32) and
     48 (bf16), as hooks recorded them, bitwise repeatable, by device time;
 47. phase 40's 3D GAN step, frame and tubelet D, at ``data=1,context=2``
     against one rank on whole clips: phase 8's bounds with the decisions
     replayed, the ranks bitwise equal, the launches by route;
 48. phase 28's job at ``data=1,context=2`` under torchrun (3 steps, eval
     and saves by rank 0), its save resumed bitwise in one process;
 49. the 2D context axis's pieces (``parallel/context.py``): ``halo`` at
     the flagship's widest rank block, forward and backward, bitwise the
     whole zero-padded tensor's slices, timed; kernels #1 and #2 two-pass
     at the GroupNorm shapes of phase 50's flagship step, as in phase 46;
 50. the flagship 2D GAN step (bf16, hinge + LeCam, clamp, the latent flips,
     crop bucket ``CTX2D_CROP``), the same with the mid-block attention, and
     the cropped step in fp32, at ``data=1,context=2`` against one rank on
     whole images, decisions replayed: the ranks bitwise equal, every
     GroupNorm two-pass and the attention on the ring; the fp32 step within
     phase 8's bounds, the bf16 steps' losses within them, their gradients'
     shares logged as PERF.md §7's witness (``ctx2d_bf16_witness``);
 51. phase 26's flagship job at ``data=1,context=2`` (3 steps, rank 0
     evaluating whole images and saving), its save resumed bitwise at
     ``data=1`` in one process.

The kernels are built in parallel, one nvcc per source. The ``kernels``
line's launches add the main paths' (phases 6, 11, 16, 19), the training
jobs' (28-29, 31-33), the served artifacts' (35-37), every data-parallel
and sharded rank's (38-43), the tools' (44) and the context ranks' and
their jobs' (47-48, 50-51). The second-to-last
line is a JSON summary of the kernels; the last line is ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits 1 and prints neither.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import tarfile
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
    # the 3D VQ job of phase 29: 2 clips of a 2 x 16 x 16 x 16 latent
    "3D job": (1024, 16384, 16),
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
    # the 3D VQ job's mid block (phase 29): 2 x 16 x 16 tokens, attn_chunk 256
    "3D job": (2, 512, 8, 32, 256, True),
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
# the HDR recipe's job of phases 31-32: tools/launch_hdr.sh's flag list as its
# command line for the JAX CLI gives it (its variables' empty defaults, the
# lr 2**-7 evaluated; tests/test_torch_hdr_jobs.py holds the two together),
# then these overrides (argparse keeps the last of a repeated flag): the
# synthetic 512 px images, 4 microbatches of 8, 4 steps, an eval every 2, and
# no wandb (the recipe's default would start it; the card's machine has no
# network, and a failed wandb.init leaves its error reporter holding the
# Trainer)
HDR_RECIPE = ["--dataset_url", "", "--vae_ch", "128", "--vae_ch_mult", "1,2,4,4,4",
              "--vae_z_channels", "64", "--use_wavelet", "true",
              "--decoder_also_perform_hr", "true", "--batch_size", "32",
              "--learning_rate_vae", "0.0078125", "--learning_rate_disc", "3e-5",
              "--do_ganloss", "--disc_type", "hinge", "--use_lecam", "true", "--do_clamp",
              "--clamp_th", "8.0", "--flip_invariance", "true", "--crop_invariance", "true",
              "--max_steps", "100000", "--evaluate_every_n_steps", "1000",
              "--run_name", "hdr_stage4"]
HDR_OVERRIDES = ["--synthetic_data", "true", "--grad_accum", "4", "--max_steps", "4",
                 "--evaluate_every_n_steps", "2", "--eval_batches", "1", "--log_every", "1",
                 "--use_wandb", "false"]
TRAIN_HDR_JOB = HDR_RECIPE + HDR_OVERRIDES
HDR_RUN = "hdr_stage4"
# the recipe's model, to serve its .pt: ch 128, ch_mult 1,2,4,4,4, z 64, the
# wavelet encoder (256 px in) and the HR decoder (512 px out)
HDR_VAE = dict(ch=128, ch_mult=(1, 2, 4, 4, 4), z_channels=64, use_wavelet=True,
               decoder_also_perform_hr=True)
# phase 32's single steps: one microbatch of phase 31's job
HDR_MICROBATCH = 8
# GroupNorms of one flagship VAE forward (encode 21 + decode 29): a train
# step's forward and backward launches each, and an eval's forward launches
JOB_GN = 50
JOB_EVAL_KEYS = ("eval/lpips", "eval/rfid_vgg_proxy", "eval/psnr", "eval/ssim")
# the 3D training jobs of phases 28-29: the train3d CLI at TVAEConfig()'s
# width (ch 64, ch_mult 1,2,4,4, 2 res blocks, z 16, bf16), 16 frames x 128
# px, batch 2; phase 28 adds the GAN loss
JOB3D_BATCH, JOB3D_FRAMES, JOB3D_RES = 2, 16, 128
TRAIN3D_JOB = ["train3d", "--vae_ch", "64", "--vae_ch_mult", "1,2,4,4",
               "--vae_num_res_blocks", "2", "--vae_z_channels", "16",
               "--vae_resolution", str(JOB3D_RES), "--frames", str(JOB3D_FRAMES),
               "--batch_size", str(JOB3D_BATCH), "--evaluate_every_n_steps", "3",
               "--eval_batches", "1", "--use_wandb", "false", "--log_every", "1"]
# phase 29's chunked mid-block attention: 256 of the 2 x 16 x 16 = 512 tokens
JOB3D_ATTN_CHUNK = 256
# phase 29's revival threshold: at vq_ema_decay 0.99 a code unused for its 3
# steps falls to 0.99^3 = 0.9703 and is revived in step 3; a code used at
# least once keeps at least 0.99^2 = 0.9801
JOB3D_REVIVE = 0.98
TRAIN3D_GAN = ["--do_ganloss", "true", "--disc_type", "hinge", "--use_lecam", "true",
               "--video_loss_frames", "4", "--ema_decay", "0.999"]
# phase 33: phase 28's GAN job with the VQ latent, 2 microbatches of 1 clip and
# the model's levels and blocks, LPIPS and D rematerialized
TRAIN3D_ACCUM = ["--reg_type", "vq", "--grad_accum", "2", "--remat", "true"]
JOB3D_EVAL_KEYS = ("eval/recon_l2", "eval/psnr", "eval/ssim", "eval/lpips")
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


def _shape_order(key: tuple) -> tuple:
    """A sort key of a (B, C, *spatial, dtype, swish) GroupNorm call."""
    return (len(key), key[:-2], str(key[-2]), key[-1])


def _shape_label(key: tuple) -> str:
    b, c, *spatial, _, _ = key
    names = "THW"[-len(spatial):]
    return (f"B={b} C={c} " + " ".join(f"{n}={v}" for n, v in zip(names, spatial))
            + f" (S={int(np.prod(spatial))})")


def gn_bwd_at_shapes(gn, shapes: dict, label: str) -> tuple[float, list]:
    """Kernel #2 against its plain version (``gn_bwd_check``) at each (B, C,
    T, H, W, dtype, swish) of ``shapes``, 5-D channels_last_3d, or (B, C, H,
    W, dtype, swish), 4-D channels_last, as a step's hooks recorded them; logs the sums of (kernel, plain, library, bound) ms
    over the calls and returns the largest max_abs_err and those sums."""
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32_backward

    gen = torch.Generator(device="cuda").manual_seed(24)
    err, sums = 0.0, [0.0] * 4
    for key in sorted(shapes, key=_shape_order):
        b, c, *spatial, dtype, swish = key
        x, wt, bs = _gn_inputs(gen, b, 0, c, dtype, tuple(spatial))
        g = _gn_inputs(gen, b, 0, c, dtype, tuple(spatial))[0] - 0.3
        res = gn_bwd_check(gn, group_norm_fp32_backward, x, g, wt, bs, swish,
                           f"{label} {_shape_label(key)}")
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
        self.code_flips = 0
        # (index, count): a context rank's block of H rows (``rows``)
        self.h_block: tuple[int, int] | None = None

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
        decision = self._own_block(module, x, decision)
        if isinstance(module, torch.nn.ReLU):
            return x * decision.to(x.dtype)
        # the pool again over x with -inf off the recorded argmaxes: the same
        # values, the gradient to the same elements, in the pool's own layout
        off = torch.full_like(x, float("-inf"))
        off.flatten(2).scatter_(2, decision.flatten(2), 0.0)
        return F.max_pool2d(x + off, module.kernel_size, module.stride, module.padding,
                            module.dilation, module.ceil_mode)

    def _own_block(self, module, x: torch.Tensor, decision: torch.Tensor) -> torch.Tensor:
        """A decision recorded on whole images, cut to the block of H rows
        that a context rank's module sees (where x holds a block and not
        the gathered image): a ReLU's mask its rows, a max-pool's argmaxes
        its output rows, re-based to the block's flat positions."""
        relu = isinstance(module, torch.nn.ReLU)
        # the rows this call gives (VGG's pools: no padding, square windows)
        rows_out = x.shape[2] if relu else (x.shape[2] - module.kernel_size) // module.stride + 1
        if self.h_block is None or x.ndim != 4 or rows_out == decision.shape[2]:
            return decision
        index, count = self.h_block
        rows = decision.shape[2] // count
        block = decision[:, :, index * rows:(index + 1) * rows]
        if relu:
            return block
        return block - index * x.shape[2] * x.shape[3]

    @contextlib.contextmanager
    def _hooked(self, modules: dict, hook):
        handles = [m.register_forward_hook(functools.partial(hook, key))
                   for key, m in self.decision_modules(modules)]
        try:
            yield self
        finally:
            for h in handles:
                h.remove()

    @contextlib.contextmanager
    def recording(self, modules: dict, codes: bool = False):
        self.calls.clear()
        with self._hooked(modules, self._record), self._codes(codes, record=True):
            yield self

    @contextlib.contextmanager
    def replaying(self, modules: dict, codes: bool = False):
        self._next.clear()
        self.code_flips = 0
        with self._hooked(modules, self._replay), self._codes(codes, record=False):
            yield self
        unused = {k: len(v) - self._next.get(k, 0) for k, v in self.calls.items()
                  if len(v) != self._next.get(k, 0)}
        if unused:
            raise AssertionError(f"recorded decisions left unused: {unused}")

    @contextlib.contextmanager
    def _codes(self, active: bool, record: bool):
        """With ``active``, the VQ search's codes as one more decision
        (``custom_ops.nearest_codes``, kernel #4 on the card): recorded, or,
        after the search has run (and launched), replaced by the recorded
        codes, the tokens that took another code counted in
        ``code_flips``. A bf16 encoder's z moves by its rounding, and a token
        near a tie between two codes then takes the other one."""
        if not active:
            yield
            return
        from vqgan_tpu_torch.ops import custom_ops

        real, key = custom_ops.nearest_codes, "vq.nearest_codes"

        def search(flat, codebook):
            codes = real(flat, codebook)
            if record:
                self.calls.setdefault(key, []).append(codes.detach().cpu())
                return codes
            i = self._next.get(key, 0)
            if i >= len(self.calls.get(key, ())):
                raise AssertionError(f"{key} called more often than on the recorded run")
            self._next[key] = i + 1
            recorded = self.calls[key][i].to(codes.device)
            self.code_flips += int((codes != recorded).sum())
            return recorded

        custom_ops.nearest_codes = search
        try:
            yield
        finally:
            custom_ops.nearest_codes = real

    def rows(self, rank: int, n: int, h_block: tuple[int, int] | None = None
             ) -> "DecisionTape":
        """The tape a data-parallel rank replays: every recorded decision's
        ``rank``-th of ``n`` equal blocks along dim 0 (the rank's rows of
        each call's batch, for a tape recorded on the global batch).
        ``h_block`` (index, count): a 2D context rank's block of the images'
        H rows, taken from each decision where the module sees a block."""
        tape = DecisionTape()
        tape.h_block = h_block
        for key, calls in self.calls.items():
            tape.calls[key] = [d.reshape((n, d.shape[0] // n) + tuple(d.shape[1:]))[rank]
                               for d in calls]
        return tape

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


def compare_step_across_devices(runs: dict, what: str, n_logits: int, vq_k: int,
                                labels: tuple[str, str] = ("cpu", "card")) -> None:
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
    gradients' share is printed for information. ``labels``: the two runs'
    names in the log lines (phases 38-40 compare one rank with two)."""
    (m_cpu, _, x_cpu), (m_gpu, _, x_gpu) = runs["cpu"], runs["cuda"]
    worst_loss, worst, bad_loss, bad_grad = step_bound_shares(runs["cpu"], runs["cuda"],
                                                              n_logits)
    bad = bad_loss + bad_grad
    log(f"train cross-device {what}: overall_vae_loss {labels[0]}="
        f"{m_cpu['overall_vae_loss']:.6f} {labels[1]}={m_gpu['overall_vae_loss']:.6f}; the "
        f"worst loss uses {worst_loss:.3f} of its bound")
    source = "the CPU" if labels[0] == "cpu" else f"the {labels[0]} run"
    for side, (name, share) in worst.items():
        log(f"train cross-device {what} {side} step-1 gradients (AdamW exp_avg), the loss "
            f"head's decisions replayed from {source}: the worst tensor, {name}, uses "
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
    (B, C, T, H, W, dtype, swish), or (B, C, H, W, dtype, swish) for a 2D
    model: the dict and the hooks."""
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
    reconstruct or a 3D step ran them, or (B, C, H, W, dtype, swish), 4-D
    channels_last, as a 2D job ran them; logs the sums of (kernel, plain,
    library, bound) ms over the calls and returns the largest max_abs_err."""
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32

    gen = torch.Generator(device="cuda").manual_seed(19)
    err, sums = 0.0, [0.0] * 4
    for key in sorted(shapes, key=_shape_order):
        b, c, *spatial, dtype, swish = key
        x, wt, bs = _gn_inputs(gen, b, 0, c, dtype, tuple(spatial))
        res = gn_check(gn, group_norm_fp32, x, wt, bs, swish, f"{label} {_shape_label(key)}")
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
    """Forward hooks that count what one training step launches from the
    model: kernel #6 at each call of a Conv3d that takes it (``conv3d``) and
    a GroupNorm forward at each call of a norm (``gn``), counted as the call
    enters, the calls that a rematerialized region makes again in the
    backward included; a backward
    launch where the backward reaches the call's output (a hook on it): the
    GroupNorm's (``gn_bwd``), kernel #6's dx where the input takes a gradient
    too (``conv3d_dx``). A forward without autograd (D's pass under
    accumulation, an eval) and a recompute, whose outputs the backward does
    not reach, launch no backward. Returns the dict (the backward counts are
    whole once the step's backward has run) and the hooks."""
    from vqgan_tpu_torch.models.blocks import FP32GroupNorm
    from vqgan_tpu_torch.models.tae import Conv3d

    seen = {"conv3d": 0, "conv3d_dx": 0, "gn": 0, "gn_bwd": 0}

    def when_reached(out, key):
        if out.requires_grad:
            out.register_hook(lambda g: seen.__setitem__(key, seen[key] + 1))

    # the forward launch is counted on entry: a recompute that stops early
    # (once it has what the backward needs) may stop inside the module, after
    # its kernel ran
    def conv_in(module, args):
        seen["conv3d"] += int(module.uses_kernel(args[0]))

    def conv_out(module, args, out):
        if module.uses_kernel(args[0]) and args[0].requires_grad:
            when_reached(out, "conv3d_dx")

    def norm_in(module, args):
        seen["gn"] += 1

    def norm_out(module, args, out):
        when_reached(out, "gn_bwd")

    hooks = []
    for m in model.modules():
        if isinstance(m, (Conv3d, FP32GroupNorm)):
            conv = isinstance(m, Conv3d)
            hooks += [m.register_forward_pre_hook(conv_in if conv else norm_in),
                      m.register_forward_hook(conv_out if conv else norm_out)]
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
    """Instruments the port's ``Trainer`` or ``Trainer3D`` for one call of
    the CLI: each train step timed by the host clock (to a device sync after
    it) and by CUDA events on the stream, its batch and state checked to lie
    on the card, the call's first batch kept; each eval and save timed;
    each restore compared, bitwise, with the live state that the previous
    call ended with (and saved), so a save that wrote a wrong tensor or
    generator state fails too. ``expect`` holds that state's
    ``device_tree`` (or its ``state_digest`` sums), one item; the restore
    takes it out, so its memory is free before the job trains. For a 3D
    job it also times each wait for a batch (the loop's ``next`` on
    ``device_prefetch``). ``watch`` (a
    ``JobWatch``) checks each step's and each eval's kernel launches, of a
    2D job or a 3D one.
    Patches the trainer modules' step factories and the classes' methods
    while active; a timing or check adds a sync to the run, no work."""

    def __init__(self, expect: list[dict] | None = None, watch=None):
        self.expect = expect or []
        self.watch = watch
        self.steps, self.evals, self.saves, self.restores = [], [], [], []
        self.marks: list[tuple[float, float]] = []  # host (start, end) of each step
        self.waits: list[float] = []  # seconds each 3D batch took to arrive
        self.first_batch = None
        self.base_bytes = 0  # device memory allocated when the call starts

    @contextlib.contextmanager
    def active(self):
        from vqgan_tpu_torch.train import checkpoint as ckpt_mod
        from vqgan_tpu_torch.train import trainer as trainer_mod
        from vqgan_tpu_torch.train import trainer3d as trainer3d_mod

        probe = self
        patched = [(trainer_mod, "make_train_step"), (trainer3d_mod, "make_train_step_3d"),
                   (trainer3d_mod, "make_train_step_3d_gan"),
                   (trainer3d_mod, "device_prefetch"),
                   (trainer_mod.Trainer, "evaluate"), (trainer_mod.Trainer, "save"),
                   (trainer3d_mod.Trainer3D, "_eval"), (trainer3d_mod.Trainer3D, "save"),
                   (ckpt_mod.CheckpointManager, "restore")]
        real = {(owner, name): getattr(owner, name) for owner, name in patched}

        def timed_step(step):
            def run(state, batch, *args):
                if batch.device.type != "cuda":
                    raise AssertionError(f"the job's batch is on {batch.device}")
                if probe.first_batch is None:
                    probe.first_batch = batch.clone()
                watching = (probe.watch.step(state) if probe.watch is not None
                            else contextlib.nullcontext())
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with watching:
                    t0 = time.perf_counter()
                    start.record()
                    out = step(state, batch, *args)
                    end.record()
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                probe.steps.append((t1 - t0, start.elapsed_time(end)))
                probe.marks.append((t0, t1))
                return out
            return run

        def make(real_make):
            return lambda *args, **kw: timed_step(real_make(*args, **kw))

        def prefetch(*args, **kw):
            batches = real[(trainer3d_mod, "device_prefetch")](*args, **kw)

            def timed():
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        return
                    probe.waits.append(time.perf_counter() - t0)
                    yield batch
            return timed()

        def timed_method(real_method, into, watch_eval=False):
            def method(self, *args):
                # the 3D trainer's eval model, or the 2D eval step's
                model = getattr(self, "eval_model", None) or getattr(
                    getattr(self, "_eval_step", None), "model", None)
                watching = (probe.watch.eval(model)
                            if watch_eval and probe.watch is not None
                            else contextlib.nullcontext())
                with watching:
                    t0 = time.perf_counter()
                    real_method(self, *args)
                    torch.cuda.synchronize()
                    into.append(time.perf_counter() - t0)
            return method

        def restore(self, state, step=None):
            out = real[(ckpt_mod.CheckpointManager, "restore")](self, state, step)
            if out is not None:
                if not probe.expect:
                    raise AssertionError("a restore with no live state to hold it against")
                expected = probe.expect.pop()
                if isinstance(expected, list):  # a ``state_digest``'s sums
                    sums = state_digest(state)[1]
                    same, n = sums == expected, len(sums) // 2
                else:
                    same, n = same_state(device_tree(state), expected)
                probe.restores.append((state.step, same, n))
            return out

        trainer_mod.make_train_step = make(real[(trainer_mod, "make_train_step")])
        for name in ("make_train_step_3d", "make_train_step_3d_gan"):
            setattr(trainer3d_mod, name, make(real[(trainer3d_mod, name)]))
        trainer3d_mod.device_prefetch = prefetch
        trainer_mod.Trainer.evaluate = timed_method(real[(trainer_mod.Trainer, "evaluate")],
                                                    self.evals, watch_eval=True)
        trainer_mod.Trainer.save = timed_method(real[(trainer_mod.Trainer, "save")], self.saves)
        trainer3d_mod.Trainer3D._eval = timed_method(
            real[(trainer3d_mod.Trainer3D, "_eval")], self.evals, watch_eval=True)
        trainer3d_mod.Trainer3D.save = timed_method(real[(trainer3d_mod.Trainer3D, "save")],
                                                    self.saves)
        ckpt_mod.CheckpointManager.restore = restore
        try:
            yield self
        finally:
            for (owner, name), value in real.items():
                setattr(owner, name, value)


def device_tree(state) -> dict:
    """``state_dict_of``'s tree of a train state with every tensor cloned
    where it lies (on the card; the generator's state on the host; a
    sharded state gathered on the card): the live state to hold a restore
    against, with no copy to the host."""
    from vqgan_tpu_torch.train.checkpoint import state_tree

    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().clone()
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(clone(v) for v in tree)
        return tree

    return clone(state.layout.gather_tree(state, state_tree(state), host=False))


def same_state(a, b) -> tuple[bool, int]:
    """Whether every tensor of two ``state_dict_of`` trees is bitwise equal
    (dtype, shape and values; b's tensors taken to a's device), and how many
    tensors they hold. Numbers are not compared: a resumed run's schedule
    sets its own lrs."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b.to(a.device))), 1
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
    """Every parameter and AdamW moment of the job's models (a ``Trainer``'s
    or a ``Trainer3D``'s), the Polyak average, the LeCam anchors, the EMA
    statistics and the step's generator on the card; returns the number of
    tensors checked."""
    st = trainer.state
    tensors = [p for m in (st.g_model, trainer.disc, trainer.lpips) if m is not None
               for p in m.parameters()]
    tensors += list((st.g_ema or {}).values())
    for opt in (st.g_opt, st.d_opt):
        for per_param in (opt.state.values() if opt is not None else ()):
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


def check_job_log(lines: list[dict], steps: range, eval_steps: list[int], what: str,
                  loss_key: str = "overall_vae_loss",
                  eval_keys: tuple = JOB_EVAL_KEYS) -> dict:
    """The steps' losses logged and finite (the lines with ``loss_key``),
    the evals' ``eval_keys`` finite (SSIM in [-1, 1]) on a line at each of
    ``eval_steps``, no eval/metrics_failed anywhere; returns the last step's
    line."""
    if any("eval/metrics_failed" in ln for ln in lines):
        raise AssertionError(f"{what}: eval/metrics_failed in the JSONL")
    losses = {ln["step"]: ln for ln in lines if loss_key in ln}
    if sorted(s for s in losses if s in steps) != list(steps):
        raise AssertionError(f"{what}: logged steps {sorted(losses)}, expected {list(steps)}")
    bad = [(s, k) for s in steps for k, v in losses[s].items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}: non-finite logged losses {bad[:5]}")
    evals = {ln["step"]: ln for ln in lines if eval_keys[0] in ln}
    if sorted(s for s in evals if s in eval_steps) != sorted(set(eval_steps)):
        raise AssertionError(f"{what}: eval lines at {sorted(evals)}, expected {eval_steps}")
    for s in eval_steps:
        vals = [evals[s].get(k) for k in eval_keys]
        if any(v is None or not np.isfinite(v) for v in vals) \
                or not -1 <= evals[s]["eval/ssim"] <= 1:
            raise AssertionError(f"{what}: eval line at step {s}: {evals[s]}")
        log(f"{what}: eval at step {s}: " + ", ".join(
            f"{k}={v:.5g}" for k, v in zip(eval_keys, vals)))
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
           "save_s": list(probe.saves), "peak_bytes": torch.cuda.max_memory_allocated(),
           "base_bytes": probe.base_bytes}
    log(f"{what}: {len(probe.steps)} steps, {host:.1f} ms per step by the host clock (to a "
        f"sync after each; steps 2-{len(probe.steps)}), {dev:.1f} ms between CUDA events; "
        f"first step {probe.steps[0][0] * 1e3:.1f} ms; eval "
        f"{', '.join(f'{t:.2f}' for t in probe.evals)} s; save (the state's host copy; its "
        f"files are written in the background) "
        f"{', '.join(f'{t:.2f}' for t in probe.saves)} s; peak memory "
        f"{out['peak_bytes'] / 2**30:.3f} GiB ({out['base_bytes'] / 2**30:.3f} of it allocated "
        f"before the call)")
    return out


def run_job(argv: list[str], what: str, expect: list[dict] | None = None,
            watch=None) -> tuple[object, JobProbe, float]:
    from vqgan_tpu_torch import cli

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with JobProbe(expect, watch).active() as probe:
        probe.base_bytes = torch.cuda.memory_allocated()
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


class JobWatch:
    """The kernel launches of each step and each eval of a 2D or 3D job,
    checked as they happen (``JobProbe`` calls ``step`` and ``eval`` around
    them): the wrappers' counts of kernel #6 (forward, dx, and by route) and
    of #1 and #2 against what the model's own hooks count
    (``count_step_launches``: every call a rematerialized region makes again
    included; an eval launches no backward); with ``vq``, ``vq_per_step``
    (search, statistics) launches a step and one search an eval; with ``ac``, the attention kernel's
    forward and backward launches and their routes, and the head_dim of the
    mid-block attentions (hooks on ``AttnBlock3D``). It also records the
    GroupNorms' (B, C, T, H, W, dtype, swish) of the steps and of the evals
    (``record_gn_shapes``) and kernel #6's (B, Ci, Co, T, H, W, dtype), so
    that ``kernels_at_job_shapes`` holds each kernel against its plain
    version at the job's own shapes. With ``track_moves`` the first two
    steps of each call record whether G and D moved."""

    def __init__(self, cc, gn, vq=None, ac=None, track_moves: bool = False,
                 vq_per_step: tuple[int, int] = (1, 1)):
        self.cc, self.gn, self.vq, self.ac = cc, gn, vq, ac
        self.vq_per_step = vq_per_step
        self.steps: list[tuple[dict, dict]] = []  # (by the wrappers, by the hooks)
        self.evals: list[tuple[dict, dict]] = []
        self.head_dims: set[int] = set()
        self.gn_shapes: dict[str, dict] = {"step": {}, "eval": {}}
        self.conv_shapes: dict[tuple, int] = {}
        self.moves: list[tuple[bool, bool]] | None = [] if track_moves else None

    def counts(self) -> dict:
        cc, gn, vq, ac = self.cc, self.gn, self.vq, self.ac
        out = {"conv3d": cc.launches, "conv3d_dx": cc.bwd_launches, "gn": gn.launches,
               "gn_bwd": gn.bwd_launches, "conv3d_tc": cc.tc_launches,
               "conv3d_fma": cc.fma_launches}
        if vq is not None:
            out.update(nearest=vq.nearest_launches, stats=vq.stats_launches)
        if ac is not None:
            out.update(attn=ac.fwd_launches, attn_bwd=ac.bwd_launches,
                       attn_tc=ac.tc_launches, attn_fma=ac.fma_launches)
        return out

    def _attn_hooks(self, model) -> list:
        from vqgan_tpu_torch.models.tae import NUM_HEADS, AttnBlock3D

        def record(module, args):
            self.head_dims.add(args[0].shape[1] // NUM_HEADS)

        return [m.register_forward_pre_hook(record) for m in model.modules()
                if isinstance(m, AttnBlock3D)]

    def _conv_hooks(self, model) -> list:
        from vqgan_tpu_torch.models.tae import Conv3d

        def record(module, args):
            x = args[0]
            if module.uses_kernel(x):  # the kernel takes x cast to the module's dtype
                key = (x.shape[0], x.shape[1], module.weight.shape[0], *x.shape[2:],
                       module.dtype)
                self.conv_shapes[key] = self.conv_shapes.get(key, 0) + 1

        return [m.register_forward_pre_hook(record) for m in model.modules()
                if isinstance(m, Conv3d)]

    @contextlib.contextmanager
    def _counted(self, model, into: list, kind: str):
        seen, hooks = count_step_launches(model)
        gn_seen, gn_hooks = record_gn_shapes(model)
        hooks += gn_hooks + self._attn_hooks(model) + self._conv_hooks(model)
        before = self.counts()
        try:
            yield seen
        finally:
            for h in hooks:
                h.remove()
        after = self.counts()
        into.append(({k: after[k] - before[k] for k in after}, dict(seen)))
        shapes = self.gn_shapes[kind]
        for key, n in gn_seen.items():
            shapes[key] = shapes.get(key, 0) + n

    @staticmethod
    def _trained(model) -> list:
        """The params an optimizer moves: all but an EMA codebook, which the
        step folds from its statistics whatever the lr."""
        return [p for n, p in model.named_parameters() if not n.endswith("reg.codebook")]

    @contextlib.contextmanager
    def step(self, state):
        models = [m for m in (state.g_model, state.d_model) if m is not None]
        track = self.moves is not None and len(self.moves) < 2
        snaps = ([[p.detach().clone() for p in self._trained(m)] for m in models] if track
                 else None)
        with self._counted(state.g_model, self.steps, "step"):
            yield
        if track:
            moved = [any(not torch.equal(p, q) for p, q in zip(self._trained(m), snap))
                     for m, snap in zip(models, snaps)]
            self.moves.append((moved[0], moved[1] if len(moved) > 1 else False))

    def eval(self, model):
        return self._counted(model, self.evals, "eval")

    def check(self, what: str, n_steps: int, n_evals: int) -> dict:
        """Each step's and eval's launches as the hooks and the options say;
        returns the launches summed over the call."""
        if (len(self.steps), len(self.evals)) != (n_steps, n_evals):
            raise AssertionError(f"{what}: watched {len(self.steps)} steps and "
                                 f"{len(self.evals)} evals, expected {n_steps} and {n_evals}")
        total: dict[str, int] = {}
        for kind, runs in (("step", self.steps), ("eval", self.evals)):
            for i, (got, seen) in enumerate(runs):
                want = dict(seen)
                if kind == "eval":  # a forward: no backward launches
                    want.update(conv3d_dx=0, gn_bwd=0)
                want.update(conv3d_tc=want["conv3d"] + want["conv3d_dx"], conv3d_fma=0)
                if self.vq is not None:
                    want.update(nearest=self.vq_per_step[0] if kind == "step" else 1,
                                stats=self.vq_per_step[1] if kind == "step" else 0)
                if self.ac is not None:  # the encoder's and the decoder's mid block
                    want.update(attn=2, attn_bwd=2 if kind == "step" else 0)
                    want.update(attn_tc=want["attn"] + want["attn_bwd"], attn_fma=0)
                if got != want:
                    raise AssertionError(f"{what}: {kind} {i}: launches {got}, expected {want}")
                for k, v in got.items():
                    total[k] = total.get(k, 0) + v
        steps_seen = self.steps[0][1] if self.steps else {}
        log(f"{what}: every step's launches equal the model's hooks, {steps_seen} a step"
            + (" (kernel #6 all on the tensor cores)" if total.get("conv3d") else "")
            + f", each eval's "
            f"{self.evals[0][0] if self.evals else {}}; the call's total {total}")
        return total


def write_clip_shards(tmp: str, n_train: int = 10, n_test: int = 2, frames: int = 24,
                      h: int = 160, w: int = 192) -> tuple[str, str]:
    """Tar shards of uint8 clips (T, H, W, 3) from a seed: the train shard
    every 5th one an .npz, the rest .npy; the test shard .npy."""
    import io
    import tarfile

    rng = np.random.default_rng(5)
    t = np.arange(frames)[:, None, None, None]
    yy, xx = (g[None, ..., None] for g in np.mgrid[0:h, 0:w])

    def clip() -> np.ndarray:
        phase = rng.uniform(0, 2 * np.pi, 3)
        wave = np.sin(xx / 9.0 + yy / 13.0 + 0.2 * t + phase)
        noise = rng.integers(0, 24, (frames, h, w, 3))
        return np.clip(110 + 100 * wave + noise, 0, 255).astype(np.uint8)

    paths = []
    for name, n in (("train", n_train), ("test", n_test)):
        path = os.path.join(tmp, f"{name}-00000.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(n):
                buf = io.BytesIO()
                if name == "train" and i % 5 == 4:
                    np.savez(buf, clip=clip())
                    member = f"{i:05d}.npz"
                else:
                    np.save(buf, clip())
                    member = f"{i:05d}.npy"
                info = tarfile.TarInfo(member)
                info.size = buf.tell()
                buf.seek(0)
                tf.addfile(info, buf)
        paths.append(path)
    return paths[0], paths[1]


def job3d_wall(probe: JobProbe, first_step: int, n: int, what: str) -> dict:
    """The 3D job's own clock: the wall time from one step's start to the
    next one's, over the steps after the call's first that no eval or save
    follows, and the loop's wait for each batch (``next`` on
    ``device_prefetch``: the synthetic clip made on the loop's thread, or
    a decoded shard batch, and its copy to the card)."""
    clean = [i for i in range(1, len(probe.marks) - 1)
             if n <= 0 or not (n == 1 or (first_step + i + 1) % n == 1)]
    wall = [(probe.marks[i + 1][0] - probe.marks[i][0]) * 1e3 for i in clean]
    # the wait for step i + 1's batch, where no save's background write ran
    waits = [probe.waits[i + 1] * 1e3 for i in clean]
    out = {"wall_ms": float(np.mean(wall)) if wall else float("nan"),
           "wait_ms": float(np.mean(waits)) if waits else float("nan")}
    log(f"{what}: wall time a step {out['wall_ms']:.1f} ms (steps "
        f"{[first_step + i for i in clean]}, start to next start), the loop's wait for the "
        f"next batch {out['wait_ms']:.1f} ms; every wait: "
        f"{', '.join(f'{w * 1e3:.1f}' for w in probe.waits)} ms (the first fills the "
        f"prefetch; one after a save overlaps its background write)")
    return out


def conv3d_at_shapes(cc, shapes, label: str) -> float:
    """Kernel #6, forward and dx, against its plain versions at each (B, Ci,
    Co, T, H, W, dtype) of ``shapes``, within the share of the bound that
    phase 18 holds it to; returns the largest max_abs_err."""
    from vqgan_tpu_torch.ops.conv3d import (
        bound_share,
        conv3d_input_grad_plain,
        conv3d_plain,
        flipped_weight,
    )

    set_tf32(False)
    gen = torch.Generator(device="cuda").manual_seed(28)
    err = 0.0
    for b, ci, co, t, h, w, dtype in sorted(shapes, key=lambda k: (k[:6], str(k[6]))):
        x, wt = _conv3d_case(gen, b, ci, co, t, h, w, dtype)
        dy = _conv3d_case(gen, b, co, ci, t, h, w, dtype)[0]
        y, dx = cc.conv3d_forward(x, wt), cc.conv3d_input_grad(dy, wt)
        ref, ref_dx = conv3d_plain(x, wt), conv3d_input_grad_plain(dy, wt)
        used = [bound_share(y, ref, x, wt), bound_share(dx, ref_dx, dy, flipped_weight(wt))]
        errs = [float((y.float() - ref.float()).abs().max()),
                float((dx.float() - ref_dx.float()).abs().max())]
        ok = max(used) <= 1.0
        log(f"conv3d {label} B={b} Ci={ci} Co={co} T={t} H={h} W={w} {dtype}: share of the "
            f"bound used fwd={used[0]:.3f} (max_abs_err {errs[0]:.3e}) dx={used[1]:.3f} "
            f"(max_abs_err {errs[1]:.3e}) {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"conv3d kernel disagrees with plain at {label}'s "
                                 f"{(b, ci, co, t, h, w, dtype)}: {used}")
        err = max(err, *errs)
        del x, wt, dy, y, dx, ref, ref_dx
    torch.cuda.empty_cache()
    return err


def kernels_at_job_shapes(gn, cc, watches: list, gn_done: dict, conv_done) -> dict:
    """Kernels #1, #2 and #6 against their plain versions at every shape the
    2D and 3D jobs' steps and evals ran them (``JobWatch``) that an earlier
    phase did not: ``gn_done`` (the 3D steps' GroupNorm shapes, phase 23,
    forward and backward) and ``conv_done`` (phase 18's bf16 and fp32
    cases). The forward at every step and eval shape, the backward at every
    step shape. Returns the largest max_abs_err of each kernel."""
    fwd, bwd, conv = {}, {}, {}
    for watch in watches:
        for kind, shapes in watch.gn_shapes.items():
            for key, n in shapes.items():
                fwd[key] = fwd.get(key, 0) + n
                if kind == "step":
                    bwd[key] = bwd.get(key, 0) + n
        for key, n in watch.conv_shapes.items():
            conv[key] = conv.get(key, 0) + n
    fwd_new = {k: n for k, n in fwd.items() if k not in gn_done}
    bwd_new = {k: n for k, n in bwd.items() if k not in gn_done}
    conv_new = [k for k in conv if k not in conv_done]
    log(f"the jobs' shapes: GroupNorm forward {len(fwd)} ({len(fwd_new)} new to this run), "
        f"backward {len(bwd)} ({len(bwd_new)} new), Conv3d {len(conv)} ({len(conv_new)} new); "
        f"the new ones against their plain versions:")
    out = {"gn": 0.0, "gn_bwd": 0.0, "conv3d": 0.0}
    if fwd_new:
        out["gn"] = gn_at_clip_shapes(gn, fwd_new, "training job")
    if bwd_new:
        out["gn_bwd"] = gn_bwd_at_shapes(gn, bwd_new, "training job")[0]
    if conv_new:
        out["conv3d"] = conv3d_at_shapes(cc, conv_new, "training job")
    return out


def phase_train3d_job(gn, cc, tmp: str) -> dict:
    """Phase 28: the 3D GAN job at TVAEConfig's width, then its resume."""
    import shutil

    from vqgan_tpu_torch.train.trainer3d import synthetic_video_batches

    set_tf32(True)
    what = "train3d job gan"
    argv = TRAIN3D_JOB + TRAIN3D_GAN + ["--ckpt_dir", tmp, "--run_name", "t"]
    run_dir = os.path.join(tmp, "t")
    n, steps = 3, 6
    evals = [s for s in range(steps) if (s + 1) % n == 1] + [steps]  # 0, 3 and the end
    for m in (cc, gn):
        for name in ("launches", "bwd_launches"):
            setattr(m, name, 0)
    cc.tc_launches = cc.fma_launches = 0
    watch = first_watch = JobWatch(cc, gn, track_moves=True)
    trainer, probe, seconds = run_job(argv + ["--max_steps", str(steps)], what, watch=watch)
    total = watch.check(what, steps, len(evals))
    check_tc_route(cc, what)
    if watch.moves != [(False, True), (True, True)]:
        raise AssertionError(f"{what}: (G, D) moved in steps 1-2: {watch.moves}; expected D "
                             f"in step 1 and G in step 2 (its lr is 0 at step 0)")
    log(f"{what}: D moved in step 1, G in step 2")
    n_tensors = check_on_card(trainer)
    lines = job_lines(run_dir, "t")
    last = check_job_log(lines, range(steps), evals, what, "loss", JOB3D_EVAL_KEYS)
    log(f"{what}: {n_tensors} state tensors on the card; last step's losses: " + ", ".join(
        f"{k}={last[k]:.5g}" for k in ("loss", "perceptual_loss", "recon_l2", "kl",
                                       "gan/discriminator_loss", "gan/generator_gan_loss")))
    strips = [os.path.join(run_dir, "eval", f"reconstructed_clip_frames_step{s}.png")
              for s in evals]
    missing = [p for p in strips if not os.path.isfile(p)]
    if missing or trainer.ckpt.steps() != [1, 4, 6]:
        raise AssertionError(f"{what}: frame strips missing {missing}; full states at "
                             f"{trainer.ckpt.steps()}, expected [1, 4, 6]")
    log(f"{what}: frame strips at steps {evals}; full states at steps {trainer.ckpt.steps()} "
        f"({os.path.getsize(trainer.ckpt.path(steps)) / 2**30:.3f} GiB each)")
    timing = job_timing(probe, what)
    timing.update(job3d_wall(probe, 0, n, what))
    timing["seconds"] = seconds
    live = [device_tree(trainer.state)]
    del trainer
    torch.cuda.empty_cache()
    for s in (1, 4):  # the resume reads the latest full state alone
        os.remove(os.path.join(run_dir, "state", f"step_{s:08d}.pt"))

    what = "train3d job gan resume"
    watch = JobWatch(cc, gn)
    trainer, probe, _ = run_job(argv + ["--max_steps", "8"], what, live, watch=watch)
    if [(s, ok) for s, ok, _ in probe.restores] != [(steps, True)]:
        raise AssertionError(f"{what}: restores {probe.restores}, expected step {steps} bitwise")
    log(f"{what}: restored step {steps}: all {probe.restores[0][2]} tensors of the state, the "
        f"generator's state included, bitwise those the first call ended with")
    resumed = watch.check(what, 2, 2)  # evals after step 7 (step_i 6) and at the end
    for k, v in resumed.items():
        total[k] += v
    want = torch.from_numpy(next(synthetic_video_batches(JOB3D_BATCH, JOB3D_FRAMES, JOB3D_RES,
                                                         seed=42 + steps)))
    if not torch.equal(probe.first_batch.cpu(), want):
        raise AssertionError(f"{what}: the first batch is not synthetic_video_batches(seed + "
                             f"{steps})'s")
    log(f"{what}: the first batch is the synthetic stream at seed + {steps}, bitwise")
    check_on_card(trainer)
    check_job_log(job_lines(run_dir, "t"), range(steps, 8), [6, 8], what, "loss",
                  JOB3D_EVAL_KEYS)
    if trainer.state.step != 8:
        raise AssertionError(f"{what}: ended at step {trainer.state.step}")
    timing["resume_step_ms"] = job_timing(probe, what)["step_ms"]
    timing["launches"] = total
    timing["watches"] = [first_watch, watch]
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)
    return timing


def phase_train3d_job_vq(gn, cc, vq, ac, tmp: str) -> dict:
    """Phase 29: the 3D recon-only VQ job with the chunked mid-block
    attention, on clip shards, for 3 steps and one eval."""
    import logging
    import shutil
    import threading

    from vqgan_tpu_torch.models.quant import apply_ema_codebook_update

    set_tf32(True)
    what = "train3d job vq"
    train_tar, test_tar = write_clip_shards(tmp)
    argv = TRAIN3D_JOB + ["--reg_type", "vq", "--vq_revive_threshold", str(JOB3D_REVIVE),
                          "--attn_chunk", str(JOB3D_ATTN_CHUNK), "--dataset_url", train_tar,
                          "--test_dataset_url", test_tar, "--num_workers", "2",
                          "--evaluate_every_n_steps", "0", "--max_steps", "3",
                          "--ckpt_dir", tmp, "--run_name", "v"]
    records: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("vqgan_tpu_torch")
    keep = Keep()
    logger.addHandler(keep)
    threads = threading.active_count()
    for m in (cc, gn, ac):
        m.bwd_launches = 0
    cc.launches = gn.launches = ac.fwd_launches = 0
    cc.tc_launches = cc.fma_launches = ac.tc_launches = ac.fma_launches = 0
    vq.nearest_launches = vq.stats_launches = 0
    watch = JobWatch(cc, gn, vq=vq, ac=ac)
    try:
        trainer, probe, seconds = run_job(argv, what, watch=watch)
    finally:
        logger.removeHandler(keep)
    total = watch.check(what, 3, 1)
    cfg = trainer.tvae_cfg
    head_dim = cfg.ch * cfg.ch_mult[-1] // 8
    if watch.head_dims != {head_dim}:
        raise AssertionError(f"{what}: mid-block head_dim {watch.head_dims}, expected "
                             f"{head_dim}")
    log(f"{what}: 1 search and 1 statistics launch a step, 1 search for the eval; the 2 + 2 "
        f"attention launches of each step on the tensor cores at head_dim {head_dim}")
    readers = [r for r in records if r.startswith("TarImageStream") and "decode_clip" in r]
    batch = probe.first_batch.float() * 127.5 + 127.5
    if len(readers) != 2 or (batch - batch.round()).abs().max() > 1e-3:
        raise AssertionError(f"{what}: reader lines {readers}; the first batch is "
                             f"{'not ' if len(readers) == 2 else ''}uint8 clips")
    log(f"{what}: batches from the clip shards ({readers[0]!r}, {readers[1]!r}); the first "
        f"batch is uint8 pixels scaled to [-1, 1]")
    deadline = time.time() + 10
    while threading.active_count() > threads and time.time() < deadline:
        time.sleep(0.05)
    if threading.active_count() != threads:
        raise AssertionError(f"{what}: {threading.active_count()} threads after the job, "
                             f"{threads} before: the decode workers did not stop")
    log(f"{what}: the decode workers stopped ({threads} threads before and after the job)")
    check_on_card(trainer)
    ema, reg = trainer.state.vq_ema, trainer.model.reg
    dead = ema["counts"] < JOB3D_REVIVE
    revived, k = int(dead.sum()), dead.numel()
    folded = apply_ema_codebook_update(reg.codebook, ema["counts"], ema["sums"], reg.ema_eps)
    if torch.equal(ema["counts"], torch.ones_like(ema["counts"])) or not 0 < revived < k \
            or not torch.equal(reg.codebook[~dead], folded[~dead]) \
            or torch.equal(reg.codebook[dead], folded[dead]):
        raise AssertionError(f"{what}: the EMA counts did not move, {revived} of {k} codes "
                             f"revived, or the codebook is not the fold of the statistics "
                             f"where no code was revived and something else where one was")
    used = int((ema["counts"] > 1.0).sum())
    log(f"{what}: EMA counts moved ({used} codes above 1 after 3 steps); {revived} of {k} "
        f"codes revived (counts below {JOB3D_REVIVE}) to encoder rows, not the fold; the rest "
        f"of the codebook is the fold of the statistics")
    lines = job_lines(os.path.join(tmp, "v"), "v")
    check_job_log(lines, range(3), [3], what, "loss", JOB3D_EVAL_KEYS[:3])
    if trainer.ckpt.steps() != [3]:
        raise AssertionError(f"{what}: full states at {trainer.ckpt.steps()}, expected [3]")
    timing = job_timing(probe, what)
    timing.update(job3d_wall(probe, 0, 0, what))
    timing["seconds"] = seconds
    timing["launches"] = total
    timing["watches"] = [watch]
    del trainer
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "v"))
    return timing


def _reset_counts(gn, cc, vq=None) -> None:
    """Every launch count of kernels #1, #2, #6 (and #4, #5) to 0."""
    gn.launches = gn.bwd_launches = 0
    cc.launches = cc.bwd_launches = cc.tc_launches = cc.fma_launches = 0
    if vq is not None:
        vq.nearest_launches = vq.stats_launches = 0


def _add_launches(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _check_moves(watch, what: str) -> None:
    if watch.moves != [(False, True), (True, True)]:
        raise AssertionError(f"{what}: (G, D) moved in steps 1-2: {watch.moves}; expected D "
                             f"in step 1 and G in step 2 (its lr is 0 at step 0)")
    log(f"{what}: D moved in step 1, G in step 2")


def phase_hdr_job(gn, cc, tmp: str) -> dict:
    """Phase 31: the HDR recipe's job (``TRAIN_HDR_JOB``) through
    ``cli.main``, its .pt served, then a resume to step 5."""
    import shutil

    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline

    set_tf32(True)
    what = "hdr job"
    argv = TRAIN_HDR_JOB + ["--ckpt_dir", tmp]
    run_dir = os.path.join(tmp, HDR_RUN)
    n, steps = 2, 4
    evals = [s for s in range(1, steps + 1) if s % n == 1]  # after steps 1 and 3
    _reset_counts(gn, cc)
    watch = first_watch = JobWatch(cc, gn, track_moves=True)
    trainer, probe, seconds = run_job(argv, what, watch=watch)
    cfg, vae_cfg = trainer.cfg, trainer.vae_cfg
    log(f"{what}: batch {cfg.batch_size} in {cfg.grad_accum} microbatches of "
        f"{cfg.batch_size // cfg.grad_accum}, {cfg.image_size} px images, encoder "
        f"{vae_cfg.resolution} px (wavelet), HR decoder {2 * vae_cfg.resolution} px, decoder "
        f"ch_mult {vae_cfg.decoder_ch_mult}; G {sum(p.numel() for p in trainer.vae.parameters())}"
        f" params, D {sum(p.numel() for p in trainer.disc.parameters())}")
    total = watch.check(what, steps, len(evals))
    _check_moves(watch, what)
    n_tensors = check_on_card(trainer)
    lines = job_lines(run_dir, HDR_RUN)
    last = check_job_log(lines, range(steps), evals, what)
    log(f"{what}: {n_tensors} state tensors on the card; last step's losses: " + ", ".join(
        f"{k}={last[k]:.5g}" for k in ("overall_vae_loss", "perceptual_loss", "kl_loss",
                                       "gan/discriminator_loss", "gan/generator_gan_loss",
                                       "gan/lecam_loss")))
    pt = os.path.join(run_dir, f"vae_epoch_final_step_{steps}.pt")
    if not os.path.isfile(pt) or trainer.ckpt.steps() != evals + [steps]:
        raise AssertionError(f"{what}: {pt} missing or full states at {trainer.ckpt.steps()}")
    log(f"{what}: full states at {trainer.ckpt.steps()} "
        f"({os.path.getsize(trainer.ckpt.path(steps)) / 2**30:.3f} GiB each)")
    timing = job_timing(probe, what)
    timing.update(job_wall(lines, range(steps), evals, what))
    timing["seconds"] = seconds
    live = [device_tree(trainer.state)]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    serve_cfg = VAEConfig(**HDR_VAE)
    side = serve_cfg.resolution
    pipe = VAEPipeline.from_checkpoint(pt, serve_cfg, device="cuda")
    images = np.random.RandomState(0).randint(0, 256, (2, side, side, 3), np.uint8)
    recon = pipe.reconstruct(images)
    if recon.shape != (2, 2 * side, 2 * side, 3) or not np.isfinite(recon).all() \
            or recon.min() < 0 or recon.max() > 1:
        raise AssertionError(f"{what}: the .pt's reconstruction {recon.shape} "
                             f"[{recon.min()}, {recon.max()}]")
    log(f"{what}: {os.path.basename(pt)} served by VAEPipeline (wavelet encoder, HR "
        f"decoder): 2 images of {side} px to {recon.shape[1]} px in "
        f"[{recon.min():.4f}, {recon.max():.4f}]")
    del pipe
    torch.cuda.empty_cache()
    for s in evals:  # the resume reads the latest full state alone
        os.remove(os.path.join(run_dir, f"vae_epoch_0_step_{s}.pt"))
        os.remove(os.path.join(run_dir, "state", f"step_{s:08d}.pt"))

    what = "hdr job resume"
    watch = JobWatch(cc, gn)
    trainer, probe, _ = run_job(argv + ["--max_steps", str(steps + 1)], what, live, watch=watch)
    if [(s, ok) for s, ok, _ in probe.restores] != [(steps, True)]:
        raise AssertionError(f"{what}: restores {probe.restores}, expected step {steps} bitwise")
    log(f"{what}: restored step {steps}: all {probe.restores[0][2]} tensors of the state, the "
        f"generator's state included, bitwise those the first call ended with")
    _add_launches(total, watch.check(what, 1, 1))  # the eval after step 5
    check_on_card(trainer)
    check_job_log(job_lines(run_dir, HDR_RUN), range(steps, steps + 1), [steps + 1], what)
    if trainer.state.step != steps + 1:
        raise AssertionError(f"{what}: ended at step {trainer.state.step}")
    timing["resume_step_ms"] = job_timing(probe, what)["step_ms"]
    timing["launches"] = total
    timing["watches"] = [first_watch, watch]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)
    log(f"{what}: {_card()}")
    return timing


def _gn_output_sums(model) -> tuple[dict, list]:
    """Forward hooks that keep, per GroupNorm of ``model``, the fp64 sum and
    absolute sum of each call's output: a recomputed call's against the
    forward's."""
    from vqgan_tpu_torch.models.blocks import FP32GroupNorm

    sums: dict[str, list] = {}

    def record(name):
        def hook(module, args, out):
            with torch.no_grad():  # no graph: the sums hold no activation
                o = out.detach()
                sums.setdefault(name, []).append(
                    (torch.sum(o, dtype=torch.float64), torch.sum(o.abs(), dtype=torch.float64)))
        return hook

    return sums, [m.register_forward_hook(record(n)) for n, m in model.named_modules()
                  if isinstance(m, FP32GroupNorm)]


def peak_by_line(run) -> tuple[int, list]:
    """``run()`` with the allocator's history on: the traced peak and the
    bytes live at it, summed by the port's source line that allocated them
    (the first ``vqgan_tpu_torch`` frame; "other" where none), largest
    first."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=400_000)
    try:
        total = torch.cuda.memory_allocated()
        run()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][torch.cuda.current_device()]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)

    def where(frames):
        for fr in frames:
            name = fr.get("filename", "")
            if "vqgan_tpu_torch" in name:
                return f"{name.split('vqgan_tpu_torch/')[-1]}:{fr.get('line')}:{fr.get('name')}"
        return "other"

    live, best, at_best = {}, total, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], where(ev.get("frames", [])))
            total += ev["size"]
            if total > best:
                best, at_best = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    by_line: dict[str, int] = {}
    for size, line in at_best.values():
        by_line[line] = by_line.get(line, 0) + size
    return best, sorted(by_line.items(), key=lambda kv: -kv[1])


def check_large_upsample() -> None:
    """The decoder's nearest upsample at the HDR eval's 32 x 256 x 512 x 512
    = 2^31 outputs (one past the largest 32-bit index): rows 0, 15 and 31
    bitwise the upsample of that row alone."""
    from vqgan_tpu_torch.ops.resize import nearest_upsample_2x

    gen = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(32, 256, 256, 256, generator=gen, device="cuda").to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    y = nearest_upsample_2x(x)
    ok = all(torch.equal(y[i:i + 1], nearest_upsample_2x(x[i:i + 1])) for i in (0, 15, 31))
    log(f"nearest upsample to {tuple(y.shape)} ({y.numel()} outputs): rows 0, 15, 31 equal "
        f"the upsample of the row alone: {ok}")
    del x, y
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the nearest upsample is wrong at 2^31 outputs")


def phase_hdr_remat(gn, cc, tmp: str) -> dict:
    """Phase 32: one HDR step at a microbatch of 8 from one state with remat
    off, "full" and "conv"; then the job at ``--grad_accum 2 --remat true``
    (microbatches of 16) for 2 steps."""
    import shutil

    from vqgan_tpu_torch import cli
    from vqgan_tpu_torch.data.loader import to_device
    from vqgan_tpu_torch.data.synthetic import synthetic_dataloader
    from vqgan_tpu_torch.train.step import StepDraws
    from vqgan_tpu_torch.train.trainer import Trainer

    set_tf32(True)
    kw = vars(cli.build_parser().parse_args(
        TRAIN_HDR_JOB + ["--batch_size", str(HDR_MICROBATCH), "--grad_accum", "1",
                         "--ckpt_dir", tmp, "--run_name", "remat"]))
    cfg, vae_cfg = cli.configs(kw)
    batch = to_device(next(synthetic_dataloader(HDR_MICROBATCH, cfg.image_size, seed=3)),
                      torch.device("cuda"))
    draws = StepDraws(flip_in=True, flip_w=True, flip_h=False, crop_h=0, crop_w=0,
                      aug_lpips_w=False, aug_lpips_h=False)
    # D's logits: a (S/16)^2 patch grid of the HR target, real and fake
    n_logits = 2 * HDR_MICROBATCH * (2 * vae_cfg.resolution // 16) ** 2
    runs, out = {}, {}

    def timed(trainer, state):
        """One step: its host and CUDA-event ms, its peak memory, what was
        allocated before it, and the (state, metrics)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        result = trainer._step(state, batch, 0, dataclasses.replace(draws))
        end.record()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3, start.elapsed_time(end),
                torch.cuda.max_memory_allocated(), base, result)

    for mode, remat, policy in (("off", False, "full"), ("full", True, "full"),
                                ("conv", True, "conv")):
        what = f"hdr step remat {mode}"
        trainer = Trainer(cfg, dataclasses.replace(vae_cfg, remat=remat, remat_policy=policy),
                          device="cuda")
        sums, hooks = _gn_output_sums(trainer.vae)
        _reset_counts(gn, cc)
        # step 1 builds AdamW's moments and cuDNN's plans (and their
        # workspaces); step 2 is the steady step
        first = timed(trainer, trainer.state)
        state, metrics = first[4]
        for h in hooks:
            h.remove()
        counts = {"gn": gn.launches, "gn_bwd": gn.bwd_launches}
        moments = {side: {n: opt.state[p]["exp_avg"].cpu() for n, p in model.named_parameters()
                          if p in opt.state}
                   for side, model, opt in (("G", trainer.vae, state.g_opt),
                                            ("D", trainer.disc, state.d_opt))}
        runs[mode] = ({k: float(v) for k, v in metrics.items()}, moments)
        # a recomputed GroupNorm reproduces the forward's output
        again = {name: len(v) - 1 for name, v in sums.items() if len(v) > 1}
        same = all(bool(torch.equal(torch.stack(c), torch.stack(v[0])))
                   for v in sums.values() for c in v[1:])
        if remat and (not again or not same):
            raise AssertionError(f"{what}: {len(again)} GroupNorms recomputed; every recompute "
                                 f"equal to its forward: {same}")
        if not remat and again:
            raise AssertionError(f"{what}: GroupNorms called again without remat: {again}")
        ms_host, ms_dev, peak, base = timed(trainer, state)[:4]
        # a third step with the allocator's history on: what is live at its peak
        traced, by_line = peak_by_line(
            lambda: trainer._step(state, batch, 0, dataclasses.replace(draws)))
        out[mode] = {"peak_bytes": peak, "base_bytes": base, "first_peak_bytes": first[2],
                     "step_ms": ms_host, "device_step_ms": ms_dev, "counts": counts,
                     "recomputed": sum(again.values())}
        log(f"{what}: at step 3's traced peak, {traced / 2**30:.3f} GiB, by the allocating line: "
            + "; ".join(f"{line} {size / 2**30:.3f}" for line, size in by_line[:8]))
        log(f"{what}: batch {HDR_MICROBATCH} at {cfg.image_size} px, step 2 {ms_host:.1f} ms by "
            f"the host clock, {ms_dev:.1f} ms between CUDA events, peak memory "
            f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} of it the state before the step); step "
            f"1 (AdamW's moments made, cuDNN's plans built) {first[0]:.1f} / {first[1]:.1f} ms, "
            f"peak {first[2] / 2**30:.3f} GiB; GroupNorm launches in step 1 {counts}, "
            f"{sum(again.values())} recomputed calls of {len(again)} GroupNorms, each bitwise "
            f"its forward's output (fp64 sums): {same}")
        del trainer, state, metrics, moments, first
        gc.collect()
        torch.cuda.empty_cache()
    for mode in ("full", "conv"):
        worst_loss, worst, bad_loss, bad_grad = step_bound_shares(runs["off"], runs[mode],
                                                                  n_logits)
        bitwise = runs[mode][0] == runs["off"][0]
        log(f"hdr step remat {mode} against off: the worst loss uses {worst_loss:.3f} of phase "
            f"8's bound, G's worst first moment {worst['G'][0]} {worst['G'][1]:.3f}, D's "
            f"{worst['D'][0]} {worst['D'][1]:.3f}; losses bitwise equal: {bitwise}")
        if bad_loss or bad_grad:
            raise AssertionError(f"remat {mode}: the step differs from remat off: "
                                 f"{(bad_loss + bad_grad)[:5]}")
    peaks = [out[m]["peak_bytes"] for m in ("full", "conv", "off")]
    if not peaks[0] < peaks[1] < peaks[2]:
        raise AssertionError(f"steady peak memory full/conv/off {[p / 2**30 for p in peaks]} "
                             f"GiB: expected full < conv < off")
    log(f"hdr step at microbatch {HDR_MICROBATCH}: steady peak memory full "
        f"{peaks[0] / 2**30:.3f} < conv {peaks[1] / 2**30:.3f} < off {peaks[2] / 2**30:.3f} GiB; "
        f"{_card()}")

    what = "hdr job accum 2 remat"
    argv = TRAIN_HDR_JOB + ["--grad_accum", "2", "--remat", "true", "--max_steps", "2",
                            "--evaluate_every_n_steps", "0", "--ckpt_dir", tmp,
                            "--run_name", "accum2"]
    _reset_counts(gn, cc)
    watch = JobWatch(cc, gn)
    trainer, probe, seconds = run_job(argv, what, watch=watch)
    if (trainer.cfg.grad_accum, trainer.vae_cfg.remat) != (2, True):
        raise AssertionError(f"{what}: the job ran grad_accum {trainer.cfg.grad_accum}, remat "
                             f"{trainer.vae_cfg.remat}")
    launches = watch.check(what, 2, 0)
    check_job_log(job_lines(os.path.join(tmp, "accum2"), "accum2"), range(2), [], what)
    out["accum2"] = job_timing(probe, what)
    out["accum2"]["seconds"] = seconds
    out["launches"] = launches
    out["watches"] = [watch]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "accum2"))
    shutil.rmtree(os.path.join(tmp, "remat"), ignore_errors=True)
    return out


def phase_train3d_accum_job(gn, cc, vq, tmp: str) -> dict:
    """Phase 33: the 3D GAN job at TVAEConfig()'s width with the VQ latent,
    ``--grad_accum 2 --remat true`` (``TRAIN3D_ACCUM``), 3 steps, then a
    resume to step 4."""
    import shutil

    set_tf32(True)
    what = "train3d job accum 2 remat"
    accum = int(TRAIN3D_ACCUM[TRAIN3D_ACCUM.index("--grad_accum") + 1])
    argv = TRAIN3D_JOB + TRAIN3D_GAN + TRAIN3D_ACCUM + ["--ckpt_dir", tmp, "--run_name", "a"]
    run_dir = os.path.join(tmp, "a")
    n, steps = 3, 3
    evals = [s for s in range(steps) if (s + 1) % n == 1] + [steps]
    # a step: D's pass searches each microbatch without statistics, G's
    # searches and takes statistics of each
    per_step = (2 * accum, accum)
    _reset_counts(gn, cc, vq)
    watch = first_watch = JobWatch(cc, gn, vq=vq, track_moves=True, vq_per_step=per_step)
    trainer, probe, seconds = run_job(argv + ["--max_steps", str(steps)], what, watch=watch)
    if (trainer.cfg.grad_accum, trainer.tvae_cfg.remat) != (accum, True):
        raise AssertionError(f"{what}: grad_accum {trainer.cfg.grad_accum}, remat "
                             f"{trainer.tvae_cfg.remat}")
    total = watch.check(what, steps, len(evals))
    log(f"{what}: kernel #5 (statistics) {per_step[1]} launches a step, one a microbatch of "
        f"G's pass; #4 (search) {per_step[0]}, D's pass and G's")
    check_tc_route(cc, what)
    _check_moves(watch, what)
    check_on_card(trainer)
    counts = trainer.state.vq_ema["counts"]
    if torch.equal(counts, torch.ones_like(counts)):
        raise AssertionError(f"{what}: the EMA counts did not move")
    lines = job_lines(run_dir, "a")
    last = check_job_log(lines, range(steps), evals, what, "loss", JOB3D_EVAL_KEYS)
    log(f"{what}: last step's losses: " + ", ".join(
        f"{k}={last[k]:.5g}" for k in ("loss", "perceptual_loss", "recon_l2", "kl",
                                       "gan/discriminator_loss", "gan/generator_gan_loss")))
    timing = job_timing(probe, what)
    timing["seconds"] = seconds
    live = [device_tree(trainer.state)]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    what = "train3d job accum 2 remat resume"
    watch = JobWatch(cc, gn, vq=vq, vq_per_step=per_step)
    trainer, probe, _ = run_job(argv + ["--max_steps", str(steps + 1)], what, live, watch=watch)
    if [(s, ok) for s, ok, _ in probe.restores] != [(steps, True)]:
        raise AssertionError(f"{what}: restores {probe.restores}, expected step {steps} bitwise")
    log(f"{what}: restored step {steps}: all {probe.restores[0][2]} tensors of the state, the "
        f"generator's state included, bitwise those the first call ended with")
    _add_launches(total, watch.check(what, 1, 2))  # evals at step 3 and at the end
    check_on_card(trainer)
    if trainer.state.step != steps + 1:
        raise AssertionError(f"{what}: ended at step {trainer.state.step}")
    timing["resume_step_ms"] = job_timing(probe, what)["step_ms"]
    timing["launches"] = total
    timing["watches"] = [first_watch, watch]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)
    log(f"{what}: {_card()}")
    return timing


def phase_hdr_cross_device() -> None:
    """Phase 34: the microbatched step with the HDR recipe's features on the
    CPU and on the card, at phase 8's reduced width (ch 64, ch_mult 1,2,4)
    with the wavelet encoder and the HR decoder, crop bucket 1, the
    heatmap-masked L1, 96 px images for a 64 px encoder and a 128 px
    target, batch 4 in 2 microbatches, remat ("full") on both devices (the
    decision tape records the recomputed calls on the CPU and replays them
    on the card); fp32, TF32 off. Losses and first moments within phase 8's
    bounds."""
    from vqgan_tpu_torch.config import TrainConfig, VAEConfig
    from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import StepDraws, make_train_step

    set_tf32(False)
    vae_cfg = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                        z_channels=16, use_wavelet=True, decoder_also_perform_hr=True,
                        enc_dtype="float32", dec_dtype="float32", remat=True)
    cfg = TrainConfig(batch_size=4, image_size=96, max_steps=10_000, grad_accum=2,
                      do_ganloss=True, disc_type="hinge", use_lecam=True, do_clamp=True,
                      flip_invariance=True, crop_invariance=True, downscale_factor=4,
                      do_pool_recon=False, recon_weight=1.0, learning_rate_disc=1e-8)
    sd_vae = _perturbed_state_dict(dataclasses.replace(vae_cfg, remat=False), seed=5)
    gen = torch.Generator().manual_seed(6)
    disc_ref = PatchDiscriminator()
    init_discriminator_(disc_ref, gen)
    with torch.no_grad():  # non-zero final heads: the GAN branch reaches G
        for k in range(1, 6):
            getattr(disc_ref, f"binary_classifier{k}")[-1].weight.normal_(0.0, 0.05,
                                                                          generator=gen)
    lpips_ref = LPIPS()
    init_lpips_(lpips_ref, gen)
    images = np.random.RandomState(7).uniform(-1, 1, (4, 96, 96, 3)).astype(np.float32)
    runs, tape = {}, DecisionTape()
    for run in ("cpu", "cuda", "cuda free"):
        dev = run.split()[0]
        with torch.device(dev):
            vae, disc, lpips = VAE(vae_cfg), PatchDiscriminator(), LPIPS()
        vae.load_state_dict(sd_vae, strict=True)
        disc.load_state_dict(disc_ref.state_dict(), strict=True)
        lpips.load_state_dict(lpips_ref.state_dict(), strict=True)
        state = create_train_state(cfg, vae, disc, vae_cfg.ch)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        draws = StepDraws(flip_in=True, flip_w=False, flip_h=True, crop_h=1, crop_w=3,
                          aug_lpips_w=False, aug_lpips_h=False)
        head = {"lpips": lpips, "disc": disc}
        t0 = time.perf_counter()
        with (tape.recording(head) if run == "cpu" else
              tape.replaying(head) if run == "cuda" else contextlib.nullcontext()):
            state, metrics = step(state, torch.from_numpy(images).to(dev), 1, draws)
        seconds = time.perf_counter() - t0
        moments = {side: {n: opt.state[p]["exp_avg"].cpu() for n, p in model.named_parameters()
                          if p in opt.state}
                   for side, model, opt in (("G", vae, state.g_opt), ("D", disc, state.d_opt))}
        runs[run] = ({k: float(v) for k, v in metrics.items()}, moments, {})
        log(f"train cross-device hdr accum {run}: step {seconds:.1f} s, recon_loss "
            f"{runs[run][0]['recon_loss']:.6f}")
    log(f"train cross-device hdr accum: {tape.describe()} recorded on the CPU (recomputed "
        f"calls included), replayed on the card")
    # D's logits: a 8x8 patch grid of the 128 px target, real and fake, a microbatch of 2
    compare_step_across_devices(runs, "hdr accum 2 wavelet + HR + crop + heatmap ch=64 "
                                "(1,2,4) 96px -> 64/128 batch 4", 2 * 2 * 64, 0)


def phase_native_decoder(tmp: str) -> dict:
    """Phase 30: the port's native image decoder on the card's host: built
    or not (the compiler's first error line and the 2D loader's decoder
    where not); where built, a PNG through ``native_pipeline`` bitwise the
    crop (uint8) and the normalization (float32) of its cv2 decode,
    ``native_probe``'s size, None for garbage; the train transform's
    images/s on one thread at 512 px (``tools/decode_rate.py``), native
    beside cv2 where it built, cv2 alone where not."""
    import tarfile

    import cv2

    from vqgan_tpu_torch.data import native
    from vqgan_tpu_torch.data.loader import create_dataloader
    from vqgan_tpu_torch.tools.decode_rate import decode_rates, test_images

    what = "native decoder"
    t0 = time.perf_counter()
    built = native.native_available()
    png = test_images()["png"]
    path = os.path.join(tmp, "png-00000.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(2):
            name = os.path.join(tmp, f"{i}.png")
            with open(name, "wb") as f:
                f.write(png)
            tf.add(name, arcname=f"{i:05d}.png")
    stream = create_dataloader(path, 2, num_workers=1, width=512, indexed=False, loop=False)
    decoder = " then ".join(stream.decoders)
    if not built:
        log(f"{what}: decoder.cpp did not build or load ({time.perf_counter() - t0:.2f} s): "
            f"{native.build_error}; the 2D loader decodes with {decoder}")
        if decoder == "native":
            raise AssertionError(f"{what}: the loader took the native transform without it")
        rates = decode_rates(512)
        log(f"{what}: the cv2 train transform at 512 px from a 700x600 image, one thread "
            f"(vqgan_tpu_torch/tools/decode_rate.py): " + "; ".join(
                f"{name} {rates[(name, 'cv2')]:.1f} images/s" for name in ("jpeg", "png")))
        return {"built": False, "rates": rates}
    log(f"{what}: decoder.cpp built and loaded in {time.perf_counter() - t0:.2f} s "
        f"({native.library_path().name}); the 2D loader's train transform: {decoder}")
    if decoder != "native":
        raise AssertionError(f"{what}: the loader decodes with {decoder}, not native")
    decoded = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    fx, fy, size = 0.4, 0.7, 512
    ox, oy = int(fx * (700 - size + 1)), int(fy * (600 - size + 1))
    crop = decoded[oy: oy + size, ox: ox + size]
    out_u8 = native.native_pipeline(png, 0, fx, fy, size, as_uint8=True)
    out_f32 = native.native_pipeline(png, 0, fx, fy, size)
    if not (np.array_equal(out_u8, crop) and np.array_equal(
            out_f32, crop.astype(np.float32) * np.float32(1 / 127.5) - np.float32(1))):
        raise AssertionError(f"{what}: native_pipeline is not the crop of cv2's decode")
    if native.native_probe(png) != (700, 600) or native.native_probe(b"garbage") is not None \
            or native.native_pipeline(b"garbage", 0, 0.0, 0.0, 8) is not None:
        raise AssertionError(f"{what}: probe {native.native_probe(png)}, garbage not None")
    log(f"{what}: a 700x600 PNG through native_pipeline is bitwise the 512 px crop of its cv2 "
        f"decode (uint8) and its normalization (float32); native_probe gives (700, 600); "
        f"garbage gives None")
    rates = decode_rates(512)
    log(f"{what}: train transform at 512 px from a 700x600 image, one thread "
        f"(vqgan_tpu_torch/tools/decode_rate.py): " + "; ".join(
            f"{name} native {rates[(name, 'native')]:.1f} images/s, cv2 "
            f"{rates[(name, 'cv2')]:.1f}" for name in ("jpeg", "png")))
    return {"built": True, "rates": rates}


# the serving artifacts of phases 35-37: encode, decode and reconstruct at
# these batches, all from one artifact, against the pipelines within
# EXPORT_ATOL (the same kernels on the same inputs)
EXPORT_BATCHES = (8, 1, 3)
EXPORT_ATOL = 1e-6
# kernel launches of one reconstruct of each artifact (and of its pipeline):
# the flagship identity model's 50 GroupNorms; with the mid-block attention
# 52 and 2 attention calls, and one search for VQ; the TVAE's 52 GroupNorms
EXPORT_LAUNCHES = {"identity": {"gn": 50, "attn": 0, "nearest": 0},
                   "vq_attn": {"gn": 52, "attn": 2, "nearest": 1},
                   "tvae": {"gn": 52, "attn": 0, "nearest": 0}}


def _zero_serving(gn, ac, vq, cc=None) -> None:
    gn.launches = ac.fwd_launches = ac.tc_launches = ac.fma_launches = 0
    vq.nearest_launches = 0
    if cc is not None:
        cc.launches = cc.tc_launches = cc.fma_launches = 0


def _serving_counts(gn, ac, vq) -> dict:
    return {"gn": gn.launches, "attn": ac.fwd_launches, "nearest": vq.nearest_launches}


def _max_err(a, b) -> float:
    a = a.float().cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    b = b.float().cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} and {tuple(b.shape)}")
    return float((a - b).abs().max())


def check_artifact(art, pipe, inputs, batches, what: str, gn, ac, vq, expect: dict) -> dict:
    """Encode, decode (of the pipeline's latents) and reconstruct of the
    artifact against the pipeline at each batch of ``batches`` (the first
    ``b`` items of ``inputs``), each within EXPORT_ATOL; then the launches
    of one reconstruct of the first batch on each side, counted from 0: equal,
    and equal to ``expect``. Returns the artifact's counts and the largest
    error."""
    worst = 0.0
    for b in batches:
        x = inputs[:b]
        z, z_ref = art.encode(x), pipe.encode(x)
        if z.dtype != torch.float32 or z.device != art.device:
            raise AssertionError(f"{what}: latents {z.dtype} on {z.device}")
        errs = (_max_err(z, z_ref), _max_err(art.decode(z_ref), pipe.decode(z_ref)),
                _max_err(art.reconstruct(x), pipe.reconstruct(x)))
        log(f"{what} batch {b}: artifact vs pipeline max_abs_err encode {errs[0]:.3e}, "
            f"decode {errs[1]:.3e}, reconstruct {errs[2]:.3e}")
        if max(errs) > EXPORT_ATOL:
            raise AssertionError(f"{what}: the artifact differs from the pipeline at batch {b}")
        worst = max(worst, *errs)
    x = inputs[:batches[0]]
    counts = {}
    for side, fn in (("artifact", art.reconstruct), ("pipeline", pipe.reconstruct)):
        _zero_serving(gn, ac, vq)
        fn(x)
        counts[side] = _serving_counts(gn, ac, vq)
    log(f"{what}: launches of one reconstruct at batch {batches[0]} {counts}")
    if counts["artifact"] != counts["pipeline"] or counts["artifact"] != expect:
        raise AssertionError(f"{what}: expected {expect} launches on both sides")
    return {"launches": counts["artifact"], "err": worst}


def time_serving(reconstruct, x, items: int, iters: int = 3) -> dict:
    """Items/s (``items`` a call: images or clip frames) of
    ``reconstruct(x)`` (ends in a device-to-host copy) by the host clock
    over ``iters`` calls after one untimed, ms a call between CUDA events,
    and the peak memory of the timed calls."""
    reconstruct(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        reconstruct(x)
    seconds = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    ms = cuda_ms(lambda: reconstruct(x), iters=iters, warmup=0)
    return {"items_per_s": items / seconds, "host_ms": seconds * 1e3, "event_ms": ms,
            "peak_bytes": peak}


def _timing_line(name: str, t: dict, unit: str, items: int) -> str:
    return (f"{name} {t['items_per_s']:.3f} {unit}/s ({t['host_ms']:.1f} ms a reconstruct by the "
            f"host clock, {t['event_ms']:.1f} ms between CUDA events, {items * 1e3 / t['event_ms']:.3f} "
            f"{unit}/s by events), peak {t['peak_bytes'] / 2**30:.3f} GiB")


def phase_export_2d(gn, ac, vq, tmp: str) -> dict:
    """Phase 35: the flagship 2D artifacts on the card. The phase 5 identity
    model's .pt exported by the CLI in a subprocess, a flagship VQ model with
    the mid-block attention (phase 14's chunk, phase 10's K) exported in
    process; each loaded and held against ``VAEPipeline``."""
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.export import ExportedVAE, export_vae
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.models.ae import init_vae
    from vqgan_tpu_torch.weights import save_weights

    set_tf32(True)
    out = {"launches": {}}
    cfg = VAEConfig()
    images = np.random.RandomState(35).randint(
        0, 256, (max(EXPORT_BATCHES), cfg.resolution, cfg.resolution, 3), np.uint8)
    path = os.path.join(tmp, "export_flagship.pt")
    save_weights(init_vae(cfg, torch.Generator().manual_seed(0)), path)
    art_dir = os.path.join(tmp, "art_flagship")
    cmd = [sys.executable, "-m", "vqgan_tpu_torch.export", "--checkpoint", path,
           "--out_dir", art_dir, "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    out["cli_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the export CLI failed (exit {proc.returncode}):\n"
                             f"{proc.stdout}{proc.stderr}")
    log(f"export 2D: {' '.join(cmd[1:])} in a subprocess: {out['cli_s']:.1f} s; "
        f"{proc.stdout.strip()}")
    t0 = time.perf_counter()
    art = ExportedVAE.load(art_dir)
    log(f"export 2D: ExportedVAE.load {time.perf_counter() - t0:.1f} s, device {art.device}, "
        f"manifest {art.manifest['format']} torch {art.manifest['torch_version']}")
    pipe = VAEPipeline.from_checkpoint(path, cfg, device="cuda")
    res = check_artifact(art, pipe, images, EXPORT_BATCHES, "export 2D identity", gn, ac, vq,
                         EXPORT_LAUNCHES["identity"])
    out["launches"]["identity"], out["err"] = res["launches"], res["err"]
    x = images[:SERVE_BATCH]
    out["identity"] = {"artifact": time_serving(art.reconstruct, x, SERVE_BATCH),
                       "pipeline": time_serving(pipe.reconstruct, x, SERVE_BATCH)}
    for side, t in out["identity"].items():
        log(_timing_line(f"export 2D identity batch {SERVE_BATCH}: {side}", t, "img",
                         SERVE_BATCH))
    del art, pipe
    torch.cuda.empty_cache()

    cfg = VAEConfig(use_attn=True, attn_chunk=ATTN_CHUNK, reg_type="vq", vq_ema_decay=0.0)
    sd = init_vae(cfg, torch.Generator().manual_seed(0)).state_dict()
    art_dir = os.path.join(tmp, "art_flagship_vq_attn")
    t0 = time.perf_counter()
    export_vae(cfg, sd, art_dir, device="cuda")
    out["export_s"] = time.perf_counter() - t0
    art = ExportedVAE.load(art_dir)
    log(f"export 2D: export_vae of the VQ + attention flagship (K={cfg.vq_codebook_size}, "
        f"attn_chunk={cfg.attn_chunk}) in process: {out['export_s']:.1f} s")
    pipe = VAEPipeline(cfg, sd, device="cuda")
    res = check_artifact(art, pipe, images, EXPORT_BATCHES, "export 2D vq + attention", gn, ac,
                         vq, EXPORT_LAUNCHES["vq_attn"])
    out["launches"]["vq_attn"], out["err"] = res["launches"], max(out["err"], res["err"])
    out["vq_attn"] = {"artifact": time_serving(art.reconstruct, x, SERVE_BATCH),
                      "pipeline": time_serving(pipe.reconstruct, x, SERVE_BATCH)}
    for side, t in out["vq_attn"].items():
        log(_timing_line(f"export 2D vq + attention batch {SERVE_BATCH}: {side}", t, "img",
                         SERVE_BATCH))
    del art, pipe
    torch.cuda.empty_cache()
    return out


def phase_export_tvae(gn, cc, ac, vq, tmp: str) -> dict:
    """Phase 36: the TVAE artifact at ``TVAEConfig()``'s width, 16f/128px,
    batch 2, against ``TVAEPipeline`` at ``conv3d_impl="direct"`` (the
    export pins it, so kernel #6 is not in the artifact)."""
    from vqgan_tpu_torch.config import TVAEConfig
    from vqgan_tpu_torch.export import ExportedTVAE, export_tvae
    from vqgan_tpu_torch.inference import TVAEPipeline
    from vqgan_tpu_torch.weights import load_weights

    set_tf32(True)
    cfg = TVAEConfig(resolution=CLIP_RES)
    auto, path = _clip_model(cfg, tmp, "tvae_export.pt")
    direct = TVAEPipeline.from_checkpoint(path, dataclasses.replace(cfg, conv3d_impl="direct"),
                                          device="cuda")
    art_dir = os.path.join(tmp, "art_tvae")
    t0 = time.perf_counter()
    export_tvae(cfg, load_weights(path), art_dir, frames=CLIP_FRAMES, device="cuda")
    out = {"export_s": time.perf_counter() - t0}
    art = ExportedTVAE.load(art_dir)
    log(f"export TVAE: export_tvae 16f/128px {out['export_s']:.1f} s; manifest "
        f"{art.manifest['encode_input']} -> {art.manifest['encode_output']}")
    clips = np.random.RandomState(36).randint(
        0, 256, (CLIP_BATCH, CLIP_FRAMES, CLIP_RES, CLIP_RES, 3), np.uint8)
    res = check_artifact(art, direct, clips, (CLIP_BATCH, 1), "export TVAE 16f/128px", gn, ac,
                         vq, EXPORT_LAUNCHES["tvae"])
    out["launches"], out["err"] = res["launches"], res["err"]
    cc.launches = 0
    art.reconstruct(clips)
    if cc.launches:
        raise AssertionError(f"{cc.launches} Conv3d kernel launches in the TVAE artifact")
    frames = CLIP_BATCH * CLIP_FRAMES
    out["timing"] = {"artifact": time_serving(art.reconstruct, clips, frames),
                     "pipeline direct": time_serving(direct.reconstruct, clips, frames),
                     "pipeline auto": time_serving(auto.reconstruct, clips, frames)}
    for side, t in out["timing"].items():
        log(_timing_line(f"export TVAE 16f/128px batch {CLIP_BATCH}: {side}", t, "frames",
                         CLIP_BATCH * CLIP_FRAMES))
    del art, direct, auto
    torch.cuda.empty_cache()
    return out


def _check_across(got, ref, fp32: bool, what: str) -> None:
    """Phase 21's bounds: ATOL_PATH_FP32 for an fp32 path, the bf16 path's
    max and mean bounds else."""
    got, ref = (t.float().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(t)
                for t in (got, ref))
    err = (got - ref).abs()
    log(f"{what}: max_abs_err={float(err.max()):.3e} mean={float(err.mean()):.3e}")
    ok = (float(err.max()) <= ATOL_PATH_FP32 if fp32 else
          float(err.max()) <= MAX_TOL_PATH_BF16 and float(err.mean()) <= MEAN_TOL_PATH_BF16)
    if not ok:
        raise AssertionError(f"{what}: outside phase 21's bounds")


def phase_export_portability(gn, ac, vq, tmp: str) -> dict:
    """Phase 37: an artifact traced on the card, loaded on the CPU, against
    the CPU pipeline; one traced on the CPU, loaded onto the card, launches
    the kernels there, against the card's pipeline. A 2D VQ model with the
    mid-block attention at phase 12's reduced width (kernels #1, #3, #4), and
    the TVAE at phase 21's (#1, #3)."""
    from vqgan_tpu_torch.config import TVAEConfig, VAEConfig
    from vqgan_tpu_torch.export import ExportedTVAE, ExportedVAE, export_tvae, export_vae
    from vqgan_tpu_torch.inference import TVAEPipeline, VAEPipeline
    from vqgan_tpu_torch.models.tae import init_tvae

    set_tf32(False)
    vae_cfg = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                        z_channels=16, reg_type="vq", vq_codebook_size=VQ_CROSS_K,
                        vq_ema_decay=0.0, **_attn_kw(True))
    vae_sd = _perturbed_state_dict(vae_cfg, seed=37)
    vae_sd["reg.codebook"] = torch.from_numpy(
        (0.5 * np.random.RandomState(37).randn(VQ_CROSS_K, 16)).astype(np.float32))
    tvae_cfg = TVAEConfig(resolution=32, ch=32, ch_mult=(1, 8), num_res_blocks=1,
                          attn_chunk=64)
    gen = torch.Generator().manual_seed(37)
    model = init_tvae(tvae_cfg, gen)
    with torch.no_grad():  # non-trivial GroupNorm affines, as in phase 21
        for name, p in model.named_parameters():
            if p.ndim == 1 and ".norm" in name:
                p.normal_(1.0 if name.endswith(".weight") else 0.0, 0.2, generator=gen)
    tvae_sd = model.state_dict()
    images = np.random.RandomState(38).randint(0, 256, (2, 64, 64, 3), np.uint8)
    clips = np.random.RandomState(39).randint(0, 256, (2, 4, 32, 32, 3), np.uint8)
    cases = (
        ("2D vq + attention", ExportedVAE, export_vae, {}, vae_cfg, vae_sd, images,
         lambda d: VAEPipeline(vae_cfg, vae_sd, device=d), ("gn", "attn", "nearest")),
        ("TVAE", ExportedTVAE, export_tvae, {"frames": 4}, tvae_cfg, tvae_sd, clips,
         lambda d: TVAEPipeline(dataclasses.replace(tvae_cfg, conv3d_impl="direct"), tvae_sd,
                                device=d), ("gn", "attn")),
    )
    launches: dict[str, int] = {}
    for what, loader, export, kw, cfg, sd, x, pipeline, kernels in cases:
        fp32_z = what.startswith("2D")  # the TVAE computes in bf16
        # traced on the card, run on the CPU
        card_dir = os.path.join(tmp, f"port_card_{loader.__name__}")
        export(cfg, sd, card_dir, device="cuda", **kw)
        art = loader.load(card_dir, device="cpu")
        cpu = pipeline("cpu")
        _check_across(art.encode(x), cpu.encode(x), fp32_z,
                      f"export {what}: traced on the card, run on the CPU, latents vs the CPU "
                      f"pipeline")
        _check_across(art.reconstruct(x), cpu.reconstruct(x), False,
                      f"export {what}: traced on the card, run on the CPU, reconstruct vs the "
                      f"CPU pipeline")
        # traced on the CPU, run on the card
        cpu_dir = os.path.join(tmp, f"port_cpu_{loader.__name__}")
        export(cfg, sd, cpu_dir, device="cpu", **kw)
        art = loader.load(cpu_dir, device="cuda")
        card = pipeline("cuda")
        _zero_serving(gn, ac, vq)
        got = art.reconstruct(x)
        counted = _serving_counts(gn, ac, vq)
        _zero_serving(gn, ac, vq)
        ref = card.reconstruct(x)
        log(f"export {what}: traced on the CPU ({art.manifest['device']}), run on "
            f"{art.device}: launches {counted}, the card's pipeline {_serving_counts(gn, ac, vq)}")
        if counted != _serving_counts(gn, ac, vq) or not all(counted[k] for k in kernels):
            raise AssertionError(f"export {what}: expected the pipeline's launches, none of "
                                 f"{kernels} zero")
        _add_launches(launches, counted)
        _check_across(art.encode(x), card.encode(x), fp32_z,
                      f"export {what}: traced on the CPU, run on the card, latents vs the card's "
                      f"pipeline")
        _check_across(got, ref, False, f"export {what}: traced on the CPU, run on the card, "
                                       f"reconstruct vs the card's pipeline")
    return launches


# ---------------------------------------------------------------------------
# phases 38-41: data parallelism, the data mesh axis (parallel/mesh.py)

# two ranks, each a process: on one card they time-slice it and talk over
# gloo; where the host has a card a rank, over NCCL
DP_RANKS = 2
DP_STEPS = 2
# the global batches: 8 flagship images (4 a rank), 2 16f/128px clips (1 a rank)
DP_BATCH, DP_CLIPS = 8, 2
# phase 39's revival as phase 12's: threshold 0.5, the EMA counts started from
# a numpy draw in [0.3, 1.3) (sums = counts x codebook), so that a code
# unused in step 1 with 0.99·c < 0.5 is revived
DP_VQ_REVIVE = 0.5
# phases 38-40's cases and each one's logits, real and fake (D's accuracy is
# held to one of them): a 16x16 patch grid at 256 px, 8x8 at 128 px
DP_CASES = {"flagship": 2 * DP_BATCH * 256, "flagship vq": 2 * DP_BATCH * 256,
            "3d gan": 2 * DP_CLIPS * 4 * 64}
# the models: VAEConfig() in bf16 (bench.py:51-55), and TVAEConfig()'s width
# (ch 64, ch_mult 1,2,4,4, 2 res blocks, z 16) at 128 px with the mid-block
# attention chunked so that kernel #3 runs, in fp32 as phase 25's 3D step:
# in bf16, 2 clips on one rank and 1 clip on each of two ranks round apart
# (other plans and cuDNN algorithms at another batch) by 11-14 times phase
# 8's bound on the encoder's moments, with dense attention and with cuDNN's
# Conv3d alike, where fp32 stays at 0.2 of it
DP_VAE = dict(enc_dtype="bfloat16", dec_dtype="bfloat16")
DP_TVAE = dict(resolution=JOB3D_RES, attn_chunk=JOB3D_ATTN_CHUNK, compute_dtype="float32")
# D's lr as phase 8's: AdamW's first step moves every D param by ±lr·sign(grad),
# and where a gradient is rounding noise two batch splits step apart, which G's
# GAN branch through the updated D carries into G's gradient
DP_D_LR = 1e-8
# phase 41: TRAIN_JOB (phase 26's flagship job) under torchrun: 3 steps with
# an eval and a save after step 1 and the final save (phase 43's resume to
# step 4 runs at this mesh); then 2 steps at one rank over NCCL against the
# same 2 steps in one plain process
DP_JOB = TRAIN_JOB + ["--mesh_shape", "data=-1"]
DP_JOB_FIRST = ["--max_steps", "3", "--evaluate_every_n_steps", "3"]
DP_JOB_RESUME = ["--max_steps", "4", "--evaluate_every_n_steps", "2"]
DP_JOB_PLAIN = ["--max_steps", "2", "--evaluate_every_n_steps", "0"]
# phase 42: the ranks of phases 38-40 again with the train state sharded over
# fsdp (parallel/fsdp.py), and both launches run the flagship step at
# grad_accum 2 (microbatches of 2 a rank) beside DP_CASES; every rank of both
# runs cuDNN deterministic with its benchmark off, so that each step's
# gathered state is the data=2 run's bit for bit
FSDP_MESH = {"data": 1, "fsdp": 2}
DP_ACCUM = "flagship accum"
# phase 43: TRAIN_JOB under torchrun with its state sharded (in phase 41's
# launch, after its job), 3 steps, an eval and a save after step 1, the final
# save after step 3; that save resumed at data=2 under torchrun and in one
# plain process, each for a fourth step
FSDP_JOB_FIRST = ["--mesh_shape", "data=1,fsdp=2", "--max_steps", "3",
                  "--evaluate_every_n_steps", "3"]
# phase 44: the tools at the flagship width (VAEConfig() as it is, which
# TRAIN_JOB's model is): the calibrator's batch, and the recompute tool's
# eval set (2 batches of 8 PNG images at the model's resolution in a tar)
TOOLS_VAE: dict = {}
TOOLS_CALIB_BATCH = 2
TOOLS_EVAL_BATCH, TOOLS_EVAL_BATCHES = 8, 2


def dp_counts() -> dict:
    """The launch counts of every kernel wrapper of the training paths."""
    from vqgan_tpu_torch.ops import attention_cuda as ac
    from vqgan_tpu_torch.ops import conv3d_cuda as cc
    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.ops import ring_attention as ring
    from vqgan_tpu_torch.ops import vq_cuda as vq

    return {"gn": gn.launches, "gn_bwd": gn.bwd_launches, "nearest": vq.nearest_launches,
            "stats": vq.stats_launches, "attn": ac.fwd_launches, "attn_bwd": ac.bwd_launches,
            "conv3d": cc.launches, "conv3d_dx": cc.bwd_launches,
            "gn_ctx_sums": gn.ctx_sums_launches, "gn_ctx_apply": gn.ctx_apply_launches,
            "gn_ctx_bwd_sums": gn.ctx_bwd_sums_launches, "gn_ctx_dx": gn.ctx_dx_launches,
            "ring": ring.fwd_launches, "ring_bwd": ring.bwd_launches}


def dp_zero_counts() -> None:
    from vqgan_tpu_torch.ops import attention_cuda as ac
    from vqgan_tpu_torch.ops import conv3d_cuda as cc
    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.ops import ring_attention as ring
    from vqgan_tpu_torch.ops import vq_cuda as vq

    _reset_counts(gn, cc, vq)
    ac.fwd_launches = ac.bwd_launches = ac.tc_launches = ac.fma_launches = 0
    gn.ctx_sums_launches = gn.ctx_apply_launches = gn.ctx_bwd_sums_launches = 0
    gn.ctx_dx_launches = ring.fwd_launches = ring.bwd_launches = 0


def dp_models() -> dict:
    """The sizes phases 38-40 run at, which the parent hands its ranks."""
    return {"vae": DP_VAE, "tvae": DP_TVAE, "batch": DP_BATCH, "clips": DP_CLIPS,
            "frames": JOB3D_FRAMES}


def dp_case(name: str, device, group=None, models: dict | None = None, context=None,
            fp32: bool = False) -> dict:
    """Case ``name`` of phases 38-40 on ``device``, its step data-parallel
    across ``group`` (None: one process on the global batch): the same
    seeded random weights in every process, D's final heads made non-zero
    (the GAN branch then reaches G), the global batch on the device, and
    LPIPS and D (the loss head, ``DecisionTape``'s modules). The step draws
    its coins, ε, the frame phase and the revival rows for the global batch
    from the state's generator, seeded alike in every process.

    "flagship": ``bench.py``'s step (``profile_step.build_flagship_step``'s
    models: bf16 encoder, decoder, LPIPS and D, hinge + LeCam + clamp,
    identity Gaussian); "flagship vq": the same with the VQ latent (K =
    16,384, D = 16, EMA 0.99), phase 12's revival (``DP_VQ_REVIVE``) and
    ``VAEConfig()``'s fp32 encoder; "3d gan":
    ``TVAEConfig()``'s width in fp32 at 16f/128px with phase 28's GAN
    (hinge + LeCam on 4 frames, frame D, fp32 D and LPIPS) and the mid-block
    attention chunked at ``JOB3D_ATTN_CHUNK``, so that kernel #3 runs;
    "flagship accum" (phase 42): "flagship" at ``grad_accum`` 2; "3d gan
    tubelet" (phase 47): "3d gan" with the tubelet D on the 4 frames;
    "flagship ctx" (phase 50): "flagship" with the latent flips and crop
    bucket ``CTX2D_CROP``; "flagship attn ctx": the flips and phase 16's
    mid-block attention (``attn_chunk`` 512), no crop; "flagship ctx fp32"
    (and ``fp32`` for any 2D case): the VAE, LPIPS and D in fp32. ``models``: the sizes
    (``dp_models()``'s where None); ``context``: the group of ranks that
    split each clip's frames (phase 47) or each image's rows (phase 50),
    with which the model and step are built (the caller cuts the batch's T
    or H)."""
    from vqgan_tpu_torch.config import TrainConfig, TVAEConfig, VAEConfig
    from vqgan_tpu_torch.losses.discriminator import (
        PatchDiscriminator,
        TubeletDiscriminator,
        init_discriminator_,
    )
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.models import blocks, tae
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.state import create_train_state
    from vqgan_tpu_torch.train.step import make_train_step
    from vqgan_tpu_torch.train.step3d import make_train_step_3d_gan
    from vqgan_tpu_torch.train.trainer3d import synthetic_video_batches

    sizes = models or dp_models()

    def seeded(seed: int) -> torch.Generator:
        return torch.Generator(device).manual_seed(seed)

    three_d = name.startswith("3d gan")
    if three_d:
        tubelet = name == "3d gan tubelet"
        model_cfg = TVAEConfig(**sizes["tvae"])
        cfg = TrainConfig(batch_size=sizes["clips"], image_size=model_cfg.resolution,
                          max_steps=10_000, do_ganloss=True, disc_type="hinge", use_lecam=True,
                          video_loss_frames=4, ema_decay=0.999,
                          disc_3d="tubelet" if tubelet else "frame", learning_rate_disc=DP_D_LR)
        with torch.device(device):
            model = tae.TVAE(model_cfg, context=context)
            disc = TubeletDiscriminator(4) if tubelet else PatchDiscriminator()
            lpips = LPIPS()
        tae.init_weights_(model, seeded(0))
        batch = torch.from_numpy(next(synthetic_video_batches(
            sizes["clips"], sizes["frames"], model_cfg.resolution, seed=0))).to(device)
    else:
        # the VQ case's encoder in fp32, VAEConfig()'s own dtypes: revival
        # copies z rows into the codebook, and a bf16 z moves by one bf16 ulp
        # between batch 8 and 4 (2^-8 at |z| in [1, 2)), past phase 12's fp32
        # bound on the folded codebook
        extra = dict(reg_type="vq", vq_revive_threshold=DP_VQ_REVIVE,
                     enc_dtype="float32") if name == "flagship vq" else {}
        if name == "flagship attn ctx":
            extra = dict(use_attn=True, attn_chunk=512)
        fp32 = fp32 or name == "flagship ctx fp32"
        if fp32:
            extra = dict(extra, enc_dtype="float32", dec_dtype="float32")
        ctx2d = name in CTX2D_CASES
        model_cfg = VAEConfig(**{**sizes["vae"], **extra})
        cfg = TrainConfig(batch_size=sizes["batch"], image_size=model_cfg.resolution,
                          max_steps=10_000, do_ganloss=True, disc_type="hinge",
                          use_lecam=True, do_clamp=True, learning_rate_disc=DP_D_LR,
                          grad_accum=2 if name == DP_ACCUM else 1, flip_invariance=ctx2d,
                          downscale_factor=model_cfg.ffactor)
        with torch.device(device):
            model = VAE(model_cfg, context=context)
            loss_dtype = torch.float32 if fp32 else torch.bfloat16
            disc, lpips = PatchDiscriminator(loss_dtype), LPIPS(loss_dtype)
        blocks.init_weights_(model, seeded(0))
        batch = torch.from_numpy(np.random.RandomState(0).uniform(
            -1, 1, (sizes["batch"], model_cfg.resolution, model_cfg.resolution, 3)).astype(
                np.float32)).to(device)
    init_discriminator_(disc, seeded(1))
    init_lpips_(lpips, seeded(2))
    heads = seeded(3)
    with torch.no_grad():
        for k in range(1, 6):
            getattr(disc, f"binary_classifier{k}")[-1].weight.normal_(0.0, 0.05,
                                                                      generator=heads)
    vq_ema = None
    if name == "flagship vq":
        counts = torch.from_numpy(np.random.RandomState(4).uniform(
            0.3, 1.3, model_cfg.vq_codebook_size).astype(np.float32)).to(device)
        vq_ema = {"counts": counts, "sums": counts[:, None] * model.reg.codebook.detach()}
    state = create_train_state(cfg, model, disc, model_cfg.ch, vq_ema=vq_ema)
    if three_d:
        step = make_train_step_3d_gan(cfg, model_cfg, model, disc, lpips,
                                      gradnorm_shards=1 if context is not None else DP_RANKS,
                                      group=group, context=context)
    else:
        base = make_train_step(cfg, model_cfg, model, disc, lpips,
                               gradnorm_shards=1 if context is not None else DP_RANKS,
                               group=group, context=context)
        crop = CTX2D_CROP if name in ("flagship ctx", "flagship ctx fp32") else 0

        def step(state, batch):
            return base(state, batch, crop)
    return {"state": state, "step": step, "batch": batch, "head": {"lpips": lpips, "disc": disc},
            "model": model, "disc": disc, "vq": name == "flagship vq"}


def dp_run_case(case: dict, rows: slice, tape, record: bool, after_step=None) -> dict:
    """DP_STEPS steps of ``case`` on its batch's ``rows``, step 1's loss-head
    decisions recorded on ``tape`` (``record``) or replayed from it (None:
    each step takes its own): each step's metrics, kernel launches, host
    and CUDA-event ms, the device memory allocated after it and the
    caching allocator's count of OOMs so far (each an allocation that
    failed, such as a cuDNN plan's workspace, after which cuDNN tries
    another plan); step 1's AdamW first moments of G and D and, for VQ, the
    EMA statistics and the folded codebook, whole (``step1_state``); the
    peak memory. ``after_step(state)`` runs after each step, outside its
    timing."""
    state, step, batch = case["state"], case["step"], case["batch"][rows]
    out = {"metrics": [], "launches": [], "ms": [], "host_ms": [], "allocated": [], "ooms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(DP_STEPS):
        # step 1 with the tape; later steps take their own decisions
        with ((tape.recording if record else tape.replaying)(case["head"], codes=case["vq"])
              if i == 0 and tape is not None else contextlib.nullcontext()):
            dp_zero_counts()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, batch)
            end.record()
            torch.cuda.synchronize()
            out["host_ms"].append((time.perf_counter() - t0) * 1e3)
            out["ms"].append(start.elapsed_time(end))
            out["launches"].append(dp_counts())
            out["allocated"].append(torch.cuda.memory_allocated())
            out["ooms"].append(torch.cuda.memory_stats().get("num_ooms", 0))
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            if after_step is not None:
                after_step(state)
            if i == 0:
                out["code_flips"] = tape.code_flips if tape is not None else 0
                out["moments"], out["extra"] = step1_state(case, state)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    bad = [k for m in out["metrics"] for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad[:5]}")
    return out


def step1_state(case: dict, state) -> tuple[dict, dict]:
    """The AdamW first moments of G and D by name and, for VQ, the EMA
    counts and sums and the folded codebook, as host copies of the whole
    tensors (a sharded state's gathered: collective)."""
    layout = state.layout
    moments = {}
    for side, prefix, model, opt in (("G", "g_model", case["model"], state.g_opt),
                                     ("D", "d_model", case["disc"], state.d_opt)):
        mine = {n: opt.state[p]["exp_avg"] for n, p in model.named_parameters()
                if p in opt.state}
        moments[side] = {n: t.float().cpu()
                         for n, t in layout.gather_named(mine, prefix=prefix).items()}
    extra = {}
    if case["vq"]:
        sums = layout.gather_named({"sums": state.vq_ema["sums"]}, prefix="vq_ema")["sums"]
        codebook = layout.gather_named({"reg.codebook": case["model"].reg.codebook})
        extra = {"counts": state.vq_ema["counts"].cpu(), "sums": sums.cpu(),
                 "codebook": codebook["reg.codebook"].detach().cpu()}
    return moments, extra


def dp_on_card(state) -> None:
    """Every parameter, AdamW moment, EMA and anchor of a train state, and
    its generator, on the card (AdamW's step counts live on the host)."""
    tensors = [p for m in (state.g_model, state.d_model) for p in m.parameters()]
    for opt in (state.g_opt, state.d_opt):
        for per in opt.state.values():
            tensors += [per["exp_avg"], per["exp_avg_sq"]]
    tensors += [state.lecam_real, state.lecam_fake, *(state.g_ema or {}).values(),
                *(state.vq_ema or {}).values()]
    off = [t.device for t in tensors if t.device.type != "cuda"]
    if off or state.generator.device.type != "cuda":
        raise AssertionError(f"{len(off)} state tensors off the card; generator on "
                             f"{state.generator.device}")


def state_digest(state) -> tuple[list[str], list[int]]:
    """Two integer sums of every tensor's bits in a train state's
    ``state_dict_of`` tree, gathered on the card (a sharded state's
    collective): the plain sum and one weighted by each element's position,
    in the tree's order, with each tensor's path. Two states with equal
    digests are bitwise equal but for a collision of both sums."""
    from vqgan_tpu_torch.train.checkpoint import state_tree

    # a stack, not a recursive closure: a closure that calls itself is a
    # reference cycle, which would keep the gathered tree on the card until
    # the next garbage collection
    flat: list[torch.Tensor] = []
    paths: list[str] = []
    stack = [("", state.layout.gather_tree(state, state_tree(state), host=False))]
    while stack:
        path, tree = stack.pop()
        if isinstance(tree, torch.Tensor):
            flat.append(tree)
            paths.append(path)
        elif isinstance(tree, dict):
            stack += [(f"{path}/{k}", tree[k]) for k in sorted(tree, key=str, reverse=True)]
        elif isinstance(tree, (list, tuple)):
            stack += [(f"{path}/{i}", v) for i, v in reversed(list(enumerate(tree)))]
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = []
    for t in flat:
        flat_t = t.detach().to("cuda").contiguous().view(-1)
        b = flat_t.view(bits[flat_t.element_size()]).to(torch.int64)
        w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) % 65521 + 1
        sums += [b.sum(), (b * w).sum()]
    return paths, torch.stack(sums).tolist()


def fsdp_saving(state) -> int:
    """The bytes a rank of F saves at rest by the fsdp rule, reckoned from
    the parameter counts before any step: each sharded parameter of G and D
    with its two AdamW moments (none for the codebook under the VQ EMA,
    which takes no gradient) and its Polyak EMA, and the VQ sums; (F - 1) /
    F of each."""
    sh = state.layout
    total = 0
    for path, plan in sh.plans.items():
        n = int(np.prod(plan.shape)) * 4
        if path == "vq_ema.sums":
            total += n
            continue
        copies = 1 + 2
        if path.endswith("reg.codebook") and state.vq_ema is not None:
            copies -= 2
        if path.startswith("g_model.") and state.g_ema is not None:
            copies += 1
        total += n * copies
    return total * (sh.n - 1) // sh.n


def dp_ranks_main(spec_path: str) -> int:
    """One rank of phases 38-40 and 42 (``chip_smoke.py --dp-ranks SPEC``
    under torchrun): joins the process group (``init_distributed``) on the
    spec's mesh (``FSDP_MESH`` for the gloo launch: its data-parallel group
    is every rank, as ``data=2``'s), then runs each case of the spec on its
    rows of the global batch with the state whole, and each of
    ``fsdp_cases`` again with it sharded (phase 42), replaying its rows of
    the one-rank run's loss-head decisions where there is a tape
    (``DP_ACCUM`` has none); after each step holds the ranks' whole
    tensors (and blocks across the data axis) equal bit for bit and takes
    the gathered state's digest and the gathers' bytes and seconds; times
    the gradient all-reduces; cuDNN deterministic, its benchmark off;
    writes its results to ``{out}/rank{r}.pt``."""
    import torch.distributed as dist

    from vqgan_tpu_torch.parallel.fsdp import FSDP, shard_state
    from vqgan_tpu_torch.parallel.mesh import create_mesh, init_distributed, replicas_equal
    from vqgan_tpu_torch.train import step as step_mod
    from vqgan_tpu_torch.train import step3d as step3d_mod
    from vqgan_tpu_torch.train.state import state_tensors

    with open(spec_path) as f:
        spec = json.load(f)
    for cfg in (spec["models"]["vae"], spec["models"]["tvae"]):  # JSON's lists: tuples
        cfg.update({k: tuple(v) for k, v in cfg.items() if isinstance(v, list)})
    device = init_distributed("cuda")
    mesh = create_mesh(spec.get("mesh", {"data": -1}))
    if device.type != "cuda":
        raise AssertionError(f"rank {mesh.rank} on {device}")
    set_tf32(spec["tf32"])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    reduces: list[tuple[int, float]] = []
    real_reduce = step_mod.reduce_gradients

    def timed_reduce(params, group):
        params = list(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(params, group)
        torch.cuda.synchronize()
        reduces.append((sum(p.grad.numel() * p.grad.element_size() for p in params
                            if p.grad is not None), time.perf_counter() - t0))

    step_mod.reduce_gradients = step3d_mod.reduce_gradients = timed_reduce
    gathers_now: list[tuple[int, float]] = []  # this step's (bytes in, seconds)
    real_gather = FSDP.gather

    def timed_gather(self, blocks, plans, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_gather(self, blocks, plans, *args, **kw)
        torch.cuda.synchronize()
        gathers_now.append((sum(b.numel() * b.element_size() for b in blocks)
                            * (self.n - 1), time.perf_counter() - t0))
        return out

    FSDP.gather = timed_gather
    real_step1_state = step1_state

    def step1_state_uncounted(case, state):
        got = real_step1_state(case, state)
        gathers_now.clear()  # the moments' gather after step 1 is no step's
        return got

    globals()["step1_state"] = step1_state_uncounted
    out = {"rank": mesh.rank, "device": str(device), "backend": dist.get_backend(mesh.group),
           "mesh": mesh.shape, "cases": {}, "fsdp": {}}
    n = mesh.world_size

    def run(name: str, sharded: bool) -> dict:
        case = dp_case(name, device, mesh.group, spec["models"])
        saving = 0
        if sharded:
            shard_state(case["state"], mesh)
            saving = fsdp_saving(case["state"])
        rows_n = case["batch"].shape[0] // n
        tape = None
        tape_path = os.path.join(spec["dir"], f"tape_{name.replace(' ', '_')}.pt")
        if os.path.exists(tape_path):
            tape = DecisionTape()
            tape.calls = torch.load(tape_path, weights_only=True)
            tape = tape.rows(mesh.rank, n)
        reduces.clear()
        gathers_now.clear()
        equal, digests, gathers, digest_paths = [], [], [], []

        def after_step(state):
            whole = replicas_equal(state_tensors(state, sharded=False), mesh.group)
            blocks = replicas_equal(state_tensors(state, sharded=True), mesh.replica_group)
            equal.append(whole and blocks)
            gathers.append((sum(b for b, _ in gathers_now), sum(t for _, t in gathers_now)))
            paths, sums = state_digest(state)
            digests.append(sums)
            digest_paths[:] = paths
            gathers_now.clear()  # the digest's own gather is no step's
            # the cache back to CUDA: the other rank's cuDNN workspaces then
            # find the card's memory as every run of the case left it
            torch.cuda.empty_cache()

        got = dp_run_case(case, slice(mesh.rank * rows_n, (mesh.rank + 1) * rows_n), tape,
                          record=False, after_step=after_step)
        got.update(replicas_equal=equal, digests=digests, digest_paths=digest_paths,
                   reduces=list(reduces), saving=saving, gathers=gathers)
        if sharded and digests[:1] == out["cases"][name]["digests"][:1]:
            # step 1 bitwise the whole run's: so are its moments (host copies
            # of ~1.3 GB a 2D case, kept only where phase 42 needs them)
            got.pop("moments")
            got.pop("extra")
        dp_on_card(case["state"])
        if mesh.rank != 0:
            got.pop("moments", None)
            got.pop("extra", None)
        del case, tape
        gc.collect()
        torch.cuda.empty_cache()
        return got

    for name in spec["cases"]:
        out["cases"][name] = run(name, sharded=False)
        if name in spec.get("fsdp_cases", ()):  # phase 42: the same rows, sharded
            out["fsdp"][name] = run(name, sharded=True)
    torch.save(out, os.path.join(spec["dir"], f"rank{mesh.rank}.pt"))
    dist.destroy_process_group()
    return 0


def dp_launch(args: list[str], nproc: int, log_path: str, timeout: int = 600) -> None:
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc`` with ``args``, its output to ``log_path``; raises with its last
    lines unless every rank exits 0."""
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               f"--nproc_per_node={nproc}", *args],
                              stdout=logf, stderr=subprocess.STDOUT, timeout=timeout,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    with open(log_path) as logf:
        text = logf.read()
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {' '.join(args[:2])} exited {proc.returncode}:\n"
                             f"{text[-6000:]}")
    log(f"torchrun --nproc_per_node={nproc} {' '.join(args[:2])}: "
        f"{time.perf_counter() - t0:.1f} s")


def phase_data_parallel_steps(tmp: str) -> dict:
    """Phases 38-40: each case's two steps at one rank on the global batch,
    recording the loss head's decisions, then at ``DP_RANKS`` ranks (one
    torchrun launch for all cases) replaying their rows of them. Each rank
    launches the one-rank run's kernels a step; after each step the ranks'
    states are bitwise equal; step 1 (losses, AdamW first moments of G and
    D, VQ statistics) within phase 8's bounds of the one-rank step
    (``compare_step_across_devices``), VQ's summed counts bitwise the
    one-rank counts. Where the host has a card a rank the flagship case runs
    again over NCCL. The gloo launch also runs ``DP_ACCUM`` (no one-rank
    run: phase 42 holds it against the sharded ranks), takes each step's
    state digest (``state_digest``) and runs phase 42's sharded layout of
    every case after the whole one. Returns the ranks' launches (the whole
    runs') and the timings."""
    # PyTorch's defaults, which the trainers run with (TF32 convolutions),
    # whatever the phase before left: phases 38-42 drive the data-parallel
    # and sharded steps as a job runs them
    set_tf32(True)
    cases = list(DP_CASES)
    ref, tf32 = {}, torch.backends.cudnn.allow_tf32
    for name in cases:
        case = dp_case(name, "cuda")
        tape = DecisionTape()
        ref[name] = dp_run_case(case, slice(None), tape, record=True)
        torch.save(tape.calls, os.path.join(tmp, f"tape_{name.replace(' ', '_')}.pt"))
        log(f"data parallel {name}: the one-rank run on the global batch recorded "
            f"{tape.describe()}; launches a step {ref[name]['launches']}")
        del case, tape
        gc.collect()
        torch.cuda.empty_cache()
    runs = [("gloo", 1)]
    if torch.cuda.device_count() >= DP_RANKS:
        runs.append(("nccl", DP_RANKS))
    log(f"data parallel: runs {[r[0] for r in runs]} (cards {torch.cuda.device_count()}); "
        f"the NCCL run needs {DP_RANKS} cards")
    launches: dict[str, int] = {}
    timing = {"ref": ref, "tf32": tf32}
    for backend, cards in runs:
        run_cases = cases + [DP_ACCUM] if backend == "gloo" else ["flagship"]
        spec = {"cases": run_cases, "dir": tmp, "tf32": tf32, "models": dp_models()}
        if backend == "gloo":  # phase 42's sharded runs in the same ranks
            spec.update(mesh=FSDP_MESH, fsdp_cases=run_cases)
        spec_path = os.path.join(tmp, "dp_spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env_cards = os.environ.get("CUDA_VISIBLE_DEVICES")
        if cards == 1:  # both ranks on the first card: gloo
            os.environ["CUDA_VISIBLE_DEVICES"] = "0" if env_cards is None else \
                env_cards.split(",")[0]
        try:
            dp_launch([os.path.abspath(__file__), "--dp-ranks", spec_path], DP_RANKS,
                      os.path.join(tmp, f"dp_{backend}.log"))
        finally:
            if env_cards is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = env_cards
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_RANKS)]
        if [r["backend"] for r in ranks] != [backend] * DP_RANKS:
            raise AssertionError(f"backends {[r['backend'] for r in ranks]}, expected {backend}")
        for name in run_cases:
            if name == DP_ACCUM:
                dp_check_ranks(name, [r["cases"][name] for r in ranks], backend)
            else:
                dp_check_case(name, ref[name], [r["cases"][name] for r in ranks], backend,
                              ranks)
            for r in ranks:
                for counted in r["cases"][name]["launches"]:
                    _add_launches(launches, counted)
        timing[backend] = ranks
    timing["launches"] = launches
    return timing


def dp_check_ranks(name: str, ranks: list[dict], backend: str, ref: dict | None = None,
                   what: str = "data parallel") -> str:
    """The ranks of a case: each the launches of ``ref`` (another run of
    the case, or rank 0), their states equal after every step (the blocks
    across the data axis), the same metrics."""
    what = f"{what} {name} ({DP_RANKS} ranks, {backend})"
    ref = ref or ranks[0]
    for r, got in enumerate(ranks):
        if got["launches"] != ref["launches"]:
            raise AssertionError(f"{what}: rank {r} launched {got['launches']}, the reference "
                                 f"run {ref['launches']}")
        if got["replicas_equal"] != [True] * DP_STEPS:
            raise AssertionError(f"{what}: the ranks' states differ after the steps "
                                 f"{got['replicas_equal']}")
    if ranks[0]["metrics"] != ranks[1]["metrics"]:
        raise AssertionError(f"{what}: the ranks logged different metrics")
    return what


def dp_check_case(name: str, ref: dict, ranks: list[dict], backend: str, info: list) -> None:
    what = dp_check_ranks(name, ranks, backend, ref)
    log(f"{what}: ranks on {[i['device'] for i in info]}; each rank's launches a step "
        f"{ranks[0]['launches']} (the one-rank run's); after each of the {DP_STEPS} steps "
        f"every tensor of the ranks' train states bitwise equal")
    runs = {"cpu": (ref["metrics"][0], ref["moments"], ref["extra"]),
            "cuda": (ranks[0]["metrics"][0], ranks[0]["moments"], ranks[0]["extra"])}
    vq_k = 16384 if name == "flagship vq" else 0
    compare_step_across_devices(runs, f"{what}, step 1 against one rank on the global batch",
                                DP_CASES[name], vq_k, labels=("one rank", f"{DP_RANKS} ranks"))
    if vq_k:
        same = torch.equal(ref["extra"]["counts"], ranks[0]["extra"]["counts"])
        revived = int((ref["extra"]["counts"] < DP_VQ_REVIVE).sum())
        log(f"{what}: step 1's search took another code than the one-rank run's for "
            f"{[r['code_flips'] for r in ranks]} tokens of the ranks (near ties under the bf16 "
            f"encoder's rounding), replayed with the one-rank codes as the loss head's "
            f"decisions are; the EMA counts after step 1 bitwise the one-rank run's: {same} "
            f"({revived} codes revived)")
        if not same or revived == 0:
            raise AssertionError(f"{what}: summed counts differ from the one-rank counts, or "
                                 f"no code revived ({revived})")
    m_ref, m_got = ref["metrics"][-1], ranks[0]["metrics"][-1]
    log(f"{what}: step {DP_STEPS} (each run's own loss-head decisions, for information) "
        f"overall_vae_loss one rank {m_ref['overall_vae_loss']:.6f}, {DP_RANKS} ranks "
        f"{m_got['overall_vae_loss']:.6f}")


def dp_jobs_main(spec_path: str) -> int:
    """One rank of phases 41 and 43 (``chip_smoke.py --dp-jobs SPEC`` under
    torchrun): the spec's jobs in turn (``rank_jobs``). Writes the ranks'
    reports, a list a rank, to ``{spec's report}.rank{r}.json``. cuDNN
    deterministic throughout."""
    import torch.distributed as dist

    from vqgan_tpu_torch.parallel.mesh import init_distributed

    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed("cuda")
    torch.backends.cudnn.deterministic = True
    reports = rank_jobs(spec["jobs"])
    with open(f"{spec['report']}.rank{dist.get_rank()}.json", "w") as f:
        json.dump(reports, f)
    dist.destroy_process_group()
    return 0


class GnShapeWatch:
    """A ``JobProbe`` watch that records the GroupNorms' (B, C, T, H, W,
    dtype, swish) of each training step (``record_gn_shapes`` on the
    step's G), summed over the steps in ``shapes``; evals are not
    recorded."""

    def __init__(self):
        self.shapes: dict[tuple, int] = {}

    @contextlib.contextmanager
    def step(self, state):
        seen, hooks = record_gn_shapes(state.g_model)
        try:
            yield
        finally:
            for h in hooks:
                h.remove()
        for key, n in seen.items():
            self.shapes[key] = self.shapes.get(key, 0) + n

    def eval(self, model):
        return contextlib.nullcontext()


def gn_shape_rows(shapes: dict, steps: int = 1) -> list[list]:
    """``record_gn_shapes``' counts as JSON rows [B, C, T, H, W, dtype
    name, swish, calls a step] ([B, C, H, W, ...] for a 2D model) over
    ``steps`` steps, in phase 3's order."""
    rows = []
    for key in sorted(shapes, key=_shape_order):
        *dims, dtype, swish = key
        if shapes[key] % steps:
            raise AssertionError(f"GroupNorm {key}: {shapes[key]} calls in {steps} steps")
        rows.append([*dims, str(dtype)[6:], bool(swish), shapes[key] // steps])
    return rows


def rank_jobs(jobs: list[dict]) -> list[dict]:
    """In a torchrun rank: for each job in turn, ``vqgan_tpu_torch.cli.main``
    of its argv under ``JobProbe`` (each step timed and checked on the card,
    each eval and save timed, a restore held bitwise against ``expect``, the
    ``state_digest`` of the live state a previous job ended with, read when
    the job starts), the kernels' launches counted; with ``digest_out`` rank
    0 writes the digest of the live state the job ends with (every rank
    takes part: a sharded state is gathered), and every rank waits for it
    before the next job; with ``gn_shapes`` the report holds the steps'
    GroupNorm shapes (``GnShapeWatch``, rows of ``gn_shape_rows``). Returns
    this rank's reports."""
    import torch.distributed as dist

    rank = dist.get_rank()
    reports = []
    for job in jobs:
        expect = None
        if job["expect"]:
            with open(job["expect"]) as f:
                expect = [json.load(f)]
        watch = GnShapeWatch() if job.get("gn_shapes") else None
        dp_zero_counts()
        trainer, probe, seconds = run_job(job["argv"], f"{job['name']} rank {rank}", expect,
                                          watch)
        checked = check_on_card(trainer)
        if job["digest_out"]:
            digest = state_digest(trainer.state)[1]
            if rank == 0:
                with open(job["digest_out"], "w") as f:
                    json.dump(digest, f)
            dist.barrier()  # a later job may restore against the file
        later = probe.steps[1:] or probe.steps
        reports.append({
            "name": job["name"], "rank": rank, "world": trainer.mesh.world_size,
            "device": str(trainer.device), "backend": dist.get_backend(trainer.mesh.group),
            "is_master": trainer.is_master, "local_batch": trainer.local_batch,
            "launches": dp_counts(), "steps": probe.steps,
            "step_ms": float(np.mean([h for h, _ in later])) * 1e3,
            "device_step_ms": float(np.mean([d for _, d in later])),
            "evals": probe.evals, "saves": probe.saves, "restores": probe.restores,
            "peak_bytes": torch.cuda.max_memory_allocated(), "on_card": checked,
            "seconds": seconds, "state_step": int(trainer.state.step),
            "mesh": trainer.mesh.shape, "sharded": trainer.state.layout.sharded,
            "gn_shapes": None if watch is None else gn_shape_rows(watch.shapes,
                                                                  len(probe.steps))})
        del trainer, probe
        gc.collect()
        torch.cuda.empty_cache()
    return reports


def dp_jobs(tmp: str, jobs: list[dict], nproc: int, tag: str,
            base: list[str] = DP_JOB) -> list[list[dict]]:
    """One torchrun launch at ``nproc`` ranks running ``jobs`` in turn
    (each ``{"name", "argv", "expect", "digest_out"}``, its argv after
    ``base`` and the run's ``--ckpt_dir``); each job's reports by rank."""
    report = os.path.join(tmp, f"job_{tag}")
    spec = {"report": report, "jobs": [
        {**job, "argv": base + ["--ckpt_dir", os.path.join(tmp, "ckpt")] + job["argv"]}
        for job in jobs]}
    spec_path = f"{report}.json"
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    dp_launch([os.path.abspath(__file__), "--dp-jobs", spec_path], nproc,
              os.path.join(tmp, f"job_{tag}.log"), timeout=900)
    by_rank = []
    for r in range(nproc):
        with open(f"{report}.rank{r}.json") as f:
            by_rank.append(json.load(f))
    return [[by_rank[r][j] for r in range(nproc)] for j in range(len(jobs))]


def phase_fsdp_steps(dp_steps: dict) -> dict:
    """Phase 42: the cases of phases 38-40 and ``DP_ACCUM`` at ``DP_RANKS``
    ranks sharing the card over gloo on ``FSDP_MESH`` with the train state
    sharded at rest (``parallel/fsdp.py``), run by phase 38-40's ranks
    after each case's whole run, replaying the same rows of the one-rank
    run's loss-head decisions. After each step every rank's gathered state
    is its whole run's bit for bit (their digests; cuDNN deterministic with
    the benchmark off), or, where it is not, within phase 8's bounds
    (``fsdp_within_bounds``); each rank launches the whole run's kernels a step
    (the one-rank run's, where there is one); each rank's device memory
    between steps is the whole run's less what the rule saves, reckoned
    from the parameter counts before the first step (``fsdp_saving``),
    within 2 % + 32 MiB. Returns the ranks' results and launches."""
    cases = list(DP_CASES) + [DP_ACCUM]
    ranks = dp_steps["gloo"]
    if [r["mesh"] for r in ranks] != [FSDP_MESH] * DP_RANKS:
        raise AssertionError(f"fsdp ranks' meshes {[r['mesh'] for r in ranks]}")
    launches: dict[str, int] = {}
    apart = []  # (case, rank, step, the paths of the tensors that differ)
    for name in cases:
        got = [r["fsdp"][name] for r in ranks]
        base = [r["cases"][name] for r in ranks]
        one = dp_steps["ref"].get(name)
        what = dp_check_ranks(name, got, "gloo", ref=one or base[0], what="fsdp")
        if got[0]["launches"] != base[0]["launches"]:
            raise AssertionError(f"{what}: launches {got[0]['launches']}, the data=2 rank's "
                                 f"{base[0]['launches']}")
        for r in range(DP_RANKS):
            for i, (a, b) in enumerate(zip(got[r]["digests"], base[r]["digests"])):
                if a != b:
                    paths = got[r]["digest_paths"]
                    apart.append((name, r, i + 1, [paths[j // 2] for j in range(0, len(a), 2)
                                                   if a[j:j + 2] != b[j:j + 2]]))
            for i in range(DP_STEPS):
                measured = base[r]["allocated"][i] - got[r]["allocated"][i]
                predicted = got[r]["saving"]
                if abs(measured - predicted) > 0.02 * predicted + (32 << 20):
                    raise AssertionError(
                        f"{what}: rank {r} after step {i + 1} holds {measured / 2**20:.1f} MiB "
                        f"less than the data=2 rank, the rule saves {predicted / 2**20:.1f}")
            for counted in got[r]["launches"]:
                _add_launches(launches, counted)
        log(f"{what}: each rank's gathered state after each of the {DP_STEPS} steps bitwise the "
            f"data=2 rank's (phases 38-40; {len(got[0]['digests'][0]) // 2} tensors, digests): "
            f"{not any(a[0] == name for a in apart)}; launches a step {got[0]['launches'][0]} "
            f"(the {'one-rank' if one else 'data=2'} run's)")
    for name, r, i, paths in apart:
        log(f"fsdp {name}: rank {r} after step {i}: {len(paths)} tensors differ from the data=2 "
            f"rank's: {paths[:12]}")
    for name in sorted({a[0] for a in apart}):
        fsdp_within_bounds(name, [r["fsdp"][name] for r in ranks],
                           [r["cases"][name] for r in ranks], dp_steps["ref"].get(name),
                           dp_steps["tf32"])
    return {"ranks": ranks, "launches": launches, "apart": apart}


def fsdp_within_bounds(name: str, got: list[dict], base: list[dict], one: dict | None,
                       tf32: bool) -> None:
    """Phase 42 for a case whose sharded state is not the data=2 run's bit
    for bit: what the run shows of why (each rank's caching-allocator OOMs
    after each step in both layouts: an allocation that failed, such as a
    cuDNN plan's workspace, sends cuDNN to another plan, whose sums round
    apart), then the sharded run held to phase 8's bounds: where step 1
    differs, its losses, AdamW first moments and VQ statistics against the
    one-rank run on the global batch (the data=2 run where there is none),
    the same loss-head decisions replayed; each later step's losses against
    the data=2 run's (each run's own decisions)."""
    what = f"fsdp {name} ({DP_RANKS} ranks, gloo)"
    log(f"{what}: not bitwise the data=2 run (cuDNN deterministic, its benchmark off, TF32 "
        f"convolutions {tf32}); allocator OOMs so far after each step: sharded "
        f"{[g['ooms'] for g in got]}, data=2 {[b['ooms'] for b in base]}; held to phase 8's "
        f"bounds instead")
    n_logits = DP_CASES.get(name, DP_CASES["flagship"])
    ref, label = (one, "one rank") if one else (base[0], "data=2")
    if "moments" in got[0]:  # step 1 differs
        compare_step_across_devices(
            {"cpu": (ref["metrics"][0], ref["moments"], ref["extra"]),
             "cuda": (got[0]["metrics"][0], got[0]["moments"], got[0]["extra"])},
            f"{what}, step 1 against {label}", n_logits,
            16384 if name == "flagship vq" else 0, labels=(label, "fsdp=2"))
    for i in range(1, DP_STEPS):
        m_ref, m_got = base[0]["metrics"][i], got[0]["metrics"][i]
        atol = {k: 1.0 / n_logits if k == "gan/discriminator_accuracy" else LOSS_ATOL
                for k in m_ref}
        bad = [(k, v, m_got[k]) for k, v in m_ref.items()
               if abs(m_got[k] - v) > atol[k] + LOSS_RTOL * abs(v)]
        worst = max(abs(m_got[k] - v) / (LOSS_ATOL + LOSS_RTOL * abs(v))
                    for k, v in m_ref.items() if k != "gan/discriminator_accuracy")
        log(f"{what}: step {i + 1}'s losses against the data=2 run's: the worst uses "
            f"{worst:.3f} of its bound")
        if bad:
            raise AssertionError(f"{what}: step {i + 1}'s losses past phase 8's bounds: "
                                 f"{bad[:5]}")


def fsdp_timing_lines(card: str, fsdp: dict) -> None:
    """Phase 42's readings, each with the card's name and power limit: a
    rank's memory allocated between steps at data=2 and sharded, against
    the saving reckoned from the parameter counts; each rank's peak; the
    gathers' MiB and ms a step (host clock between syncs), the step's ms by
    events beside the data=2 rank's."""
    for name in fsdp["ranks"][0]["fsdp"]:
        for r, rank in enumerate(fsdp["ranks"]):
            g, b = rank["fsdp"][name], rank["cases"][name]
            log(f"[{card}] fsdp {name}: rank {r} between steps {g['allocated'][-1] / 2**20:.1f} "
                f"MiB allocated, the data=2 rank {b['allocated'][-1] / 2**20:.1f} MiB: "
                f"{(b['allocated'][-1] - g['allocated'][-1]) / 2**20:.1f} MiB less, the rule's "
                f"reckoning {g['saving'] / 2**20:.1f} MiB; peak {g['peak_bytes'] / 2**30:.3f} "
                f"GiB (data=2 {b['peak_bytes'] / 2**30:.3f}); gathers a step " + ", ".join(
                    f"{nb / 2**20:.1f} MiB in {t * 1e3:.1f} ms" for nb, t in g["gathers"])
                + f"; step {DP_STEPS} {g['ms'][-1]:.1f} ms by events ({g['host_ms'][-1]:.1f} "
                f"host), data=2 {b['ms'][-1]:.1f} ({b['host_ms'][-1]:.1f})")


def phase_data_parallel_jobs(tmp: str) -> dict:
    """Phases 41 and 43: ``TRAIN_JOB`` (the flagship job, batch 8 of 512 px
    synthetic images, hinge + LeCam, bf16) through ``python -m
    torch.distributed.run --nproc_per_node 2`` and ``vqgan_tpu_torch.cli``,
    the ranks sharing the card over gloo. One launch runs phase 41's job at
    ``data=2`` (``DP_JOB_FIRST``: 3 steps, an eval and a save after step 1,
    the final save) and then phase 43's at ``data=1,fsdp=2``
    (``FSDP_JOB_FIRST``: the same with the state sharded, the other rank
    gathering with rank 0 for its eval and saves); only rank 0 evaluates,
    logs and writes. Then the same launch resumes the sharded job's step-3
    save at ``data=2`` (a third job, which saves a launch's ~30 s of process
    and CUDA start), and one plain process resumes it too, each restore
    bitwise the live state the sharded ranks ended with (its
    ``state_digest``), each training step 4. Then the job at one rank over
    NCCL (a torchrun launch of its own), 2 steps, ends in the state
    (digest) that the same 2 steps in this process end in with no process
    group (cuDNN deterministic in both). Leaves the sharded job's two reference ``.pt`` files in
    ``{tmp}/tools_ckpt`` for phase 44. Returns the reports and launches."""
    import shutil

    digest_fsdp = os.path.join(tmp, "digest_fsdp.json")
    digest_nccl = os.path.join(tmp, "digest_nccl.json")
    weights = ["vae_epoch_0_step_1.pt", "vae_epoch_final_step_3.pt"]
    dp_first, fsdp_first, resumed = dp_jobs(tmp, [
        {"name": "data parallel job", "argv": DP_JOB_FIRST + ["--run_name", "dp"],
         "expect": "", "digest_out": ""},
        {"name": "fsdp job", "argv": FSDP_JOB_FIRST + ["--run_name", "fsdp"],
         "expect": "", "digest_out": digest_fsdp},
        {"name": "data parallel resume of the fsdp job",
         "argv": DP_JOB_RESUME + ["--run_name", "fsdp"], "expect": digest_fsdp,
         "digest_out": ""}], DP_RANKS, "first")
    # what the fsdp job wrote, before its data=2 resume (which adds the step-4
    # save and weights and logs step 3 under a second config header)
    resume_files = {"state": ["step_00000004.pt"], "weights": ["vae_epoch_final_step_4.pt"]}
    for launch, name, mesh in ((dp_first, "dp", {"data": DP_RANKS}),
                               (fsdp_first, "fsdp", FSDP_MESH)):
        what = f"{launch[0]['name']} ({DP_RANKS} ranks, {mesh})"
        seen = [(r["backend"], r["local_batch"], r["mesh"], r["sharded"]) for r in launch]
        if seen != [("gloo", TRAIN_BATCH // DP_RANKS, mesh, name == "fsdp")] * DP_RANKS:
            raise AssertionError(f"{what}: (backend, local batch, mesh, sharded) {seen}")
        if [r["is_master"] for r in launch] != [True, False] \
                or [len(r["evals"]) for r in launch] != [1, 0]:
            raise AssertionError(f"{what}: rank 0 alone evaluates "
                                 f"{[(r['is_master'], len(r['evals'])) for r in launch]}")
        for r in launch:
            if len(r["steps"]) != 3 or r["launches"]["gn_bwd"] != JOB_GN * 3 \
                    or r["launches"]["gn"] != JOB_GN * (3 + len(r["evals"])):
                raise AssertionError(f"{what}: rank {r['rank']}: {len(r['steps'])} steps, "
                                     f"launches {r['launches']}")
        run_dir = os.path.join(tmp, "ckpt", name)
        lines = job_lines(run_dir, name)
        first_header = [i for i, ln in enumerate(lines) if "_config" in ln][:2]
        if name == "fsdp":  # the job's own lines, before its resume's header
            lines = lines[:first_header[1]] if len(first_header) > 1 else lines
        check_job_log(lines, range(0, 3), [1], what)
        logged = [ln["step"] for ln in lines if "overall_vae_loss" in ln]
        headers = [ln for ln in lines if "_config" in ln]
        later = resume_files if name == "fsdp" else {"state": [], "weights": []}
        saved = sorted(set(os.listdir(os.path.join(run_dir, "state"))) - set(later["state"]))
        written = sorted({n for n in os.listdir(run_dir) if n.endswith(".pt")}
                         - set(later["weights"]))
        if len(headers) != 1 or logged != [0, 1, 2] \
                or saved != ["step_00000001.pt", "step_00000003.pt"] or written != weights:
            raise AssertionError(f"{what}: {len(headers)} config headers, steps logged "
                                 f"{logged}, saved {saved}, {written}")
        log(f"{what}: {launch[0]['seconds']:.1f} s; ranks on {[r['device'] for r in launch]} "
            f"over gloo, {TRAIN_BATCH // DP_RANKS} images a rank; rank 0 alone evaluated and "
            f"wrote: one config header, steps {logged} logged once each, {saved}, {written}")
    run_dir = os.path.join(tmp, "ckpt", "fsdp")
    tools_dir = os.path.join(tmp, "tools_ckpt")
    os.makedirs(tools_dir)
    for n in weights:
        os.link(os.path.join(run_dir, n), os.path.join(tools_dir, n))
    one_dir = os.path.join(tmp, "ckpt", "fsdp_one", "state")
    os.makedirs(one_dir)
    os.link(os.path.join(run_dir, "state", "step_00000003.pt"),
            os.path.join(one_dir, "step_00000003.pt"))
    shutil.rmtree(os.path.join(tmp, "ckpt", "dp"))

    what = f"the fsdp job's save ({FSDP_MESH})"
    for r in resumed:
        if r["sharded"] or r["mesh"] != {"data": DP_RANKS} or len(r["steps"]) != 1 \
                or [(s, same) for s, same, _ in r["restores"]] != [(3, True)]:
            raise AssertionError(f"{what}: the data=2 resume, rank {r['rank']}: sharded "
                                 f"{r['sharded']}, restored {r['restores']}, "
                                 f"{len(r['steps'])} steps")
    lines = job_lines(run_dir, "fsdp")
    logged = [ln["step"] for ln in lines if "overall_vae_loss" in ln]
    if len([ln for ln in lines if "_config" in ln]) != 2 or logged != [0, 1, 2, 3]:
        raise AssertionError(f"{what}: after the data=2 resume, steps logged {logged}")
    with open(digest_fsdp) as f:
        expect = [json.load(f)]
    dp_zero_counts()
    plain, probe, _ = run_job(TRAIN_JOB + ["--ckpt_dir", os.path.join(tmp, "ckpt"),
                                           "--run_name", "fsdp_one"] + DP_JOB_RESUME,
                              f"{what}: resumed in one plain process", expect)
    one_launches = dp_counts()
    if plain.mesh.group is not None or [(s, same) for s, same, _ in probe.restores] != [
            (3, True)] or len(probe.steps) != 1:
        raise AssertionError(f"{what}: the one-process resume restored {probe.restores}, "
                             f"{len(probe.steps)} steps")
    log(f"{what}: restored bitwise the live state the sharded ranks ended with "
        f"({resumed[0]['restores'][0][2]} tensors, digests) on both ranks at data=2 "
        f"({resumed[0]['seconds']:.1f} s) and in one plain process; each trained step 4")
    del plain, probe
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "ckpt"))

    (nccl,) = dp_jobs(tmp, [{"name": "data parallel job over NCCL",
                             "argv": DP_JOB_PLAIN + ["--run_name", "nccl"], "expect": "",
                             "digest_out": digest_nccl}], 1, "nccl")
    if nccl[0]["backend"] != "nccl":
        raise AssertionError(f"the one-rank job's backend: {nccl[0]['backend']}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        dp_zero_counts()
        plain, _, _ = run_job(TRAIN_JOB + ["--ckpt_dir", os.path.join(tmp, "ckpt"),
                                           "--run_name", "plain"] + DP_JOB_PLAIN,
                              "data parallel job, one plain process")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    plain_launches = dp_counts()
    with open(digest_nccl) as f:
        same = state_digest(plain.state)[1] == json.load(f)
    if plain.mesh.group is not None:
        raise AssertionError("the plain job has a process group")
    log(f"data parallel job at one rank over NCCL ({nccl[0]['device']}) against one plain "
        f"process, 2 steps: the states bitwise equal (digests): {same}; launches "
        f"{nccl[0]['launches']} and {plain_launches}")
    if not same or nccl[0]["launches"] != plain_launches:
        raise AssertionError("the one-rank NCCL job and the plain job end apart")
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(tmp, "ckpt"))
    launches: dict[str, int] = {}
    for counted in (*[r["launches"] for r in (*dp_first, *fsdp_first, *resumed, *nccl)],
                    one_launches):
        _add_launches(launches, counted)
    return {"first": dp_first, "fsdp_first": fsdp_first, "resume": resumed, "nccl": nccl,
            "launches": launches, "weights": [os.path.join(tools_dir, n) for n in weights]}


def write_image_shard(path: str, n: int, size: int) -> None:
    """A tar shard of ``n`` seeded PNG images, ``size`` px square:
    smooth stripes and noise, so the recompute tool scores a real
    reconstruction."""
    from vqgan_tpu_torch.utils.logging import write_png

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            img = 127 + 90 * np.sin(xx[..., None] / (4 + i) + yy[..., None] / (7 + i % 5)
                                    + np.arange(3)) + rng.randint(-25, 25, (size, size, 3))
            png = f"{path}.{i}.png"
            write_png(png, np.clip(img, 0, 255).astype(np.uint8))
            tf.add(png, arcname=f"img{i:03d}.png")
            os.remove(png)


def phase_tools(tmp: str, weights: list[str]) -> dict:
    """Phase 44: the three tools on the card at the flagship width
    (``VAEConfig()``): one ``adjust_weight_init`` iteration (muP start, a
    batch of ``TOOLS_CALIB_BATCH`` 256 px images, three forwards: 3 x 50
    GroupNorm launches); ``make_alt_lpips``'s judge file; then
    ``recompute_eval_metrics`` over phase 43's two ``.pt`` files on a shard
    of 16 PNG images, judged by the default net and that file (2 x 2 x 50
    GroupNorm launches). Every row printed; the stds, PSNR, SSIM and both
    judges finite, the judges >= 0. Returns the launches."""
    import contextlib as ctx
    import io

    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.models.blocks import init_weights_
    from vqgan_tpu_torch.tools import make_alt_lpips, recompute_eval_metrics
    from vqgan_tpu_torch.tools.unit_activation_reinit import adjust_weight_init

    launches: dict[str, int] = {}
    cfg = VAEConfig(**TOOLS_VAE)
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.device("cuda"):
        model = VAE(cfg)
    init_weights_(model, gen)
    batch = torch.rand((TOOLS_CALIB_BATCH, cfg.resolution, cfg.resolution, 3), generator=gen,
                       device="cuda") * 2 - 1
    dp_zero_counts()
    t0 = time.perf_counter()
    _, report = adjust_weight_init(model, batch, max_iters=1, generator=gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = dp_counts()
    _add_launches(launches, counted)
    finals = {k: v for k, v in report.items() if "final_act_std" in v}
    if counted["gn"] != 3 * JOB_GN or not finals or not all(
            np.isfinite([v["initial_act_std"], v["final_act_std"]]).all()
            for v in finals.values()):
        raise AssertionError(f"tools: adjust_weight_init launched {counted}, report "
                             f"{list(report.items())[:3]}")
    log(f"tools: adjust_weight_init, one iteration at VAEConfig() (batch {TOOLS_CALIB_BATCH}, "
        f"{cfg.resolution} px), {seconds:.1f} s, launches {counted}; layer: initial -> final "
        f"std: " + "; ".join(f"{k}: {v['initial_act_std']:.3f} -> {v['final_act_std']:.3f}"
                            for k, v in sorted(finals.items())))
    del model, batch
    torch.cuda.empty_cache()

    judge = os.path.join(tmp, "alt_lpips.npz")
    make_alt_lpips.main(["--seed", "7", "--out", judge])
    shard = os.path.join(tmp, "eval_images.tar")
    write_image_shard(shard, TOOLS_EVAL_BATCH * TOOLS_EVAL_BATCHES, cfg.resolution)
    args = recompute_eval_metrics.build_parser().parse_args([
        "--ckpt_glob", os.path.join(os.path.dirname(weights[0]), "vae_epoch_*_step_*.pt"),
        "--test_dataset_url", shard, "--batch_size", str(TOOLS_EVAL_BATCH),
        "--eval_batches", str(TOOLS_EVAL_BATCHES), "--judge_lpips", f"default,{judge}",
        "--vae_ch", str(cfg.ch), "--vae_ch_mult", ",".join(map(str, cfg.ch_mult)),
        "--vae_z_channels", str(cfg.z_channels), "--vae_resolution", str(cfg.resolution),
        "--image_size", str(cfg.resolution), "--device", "cuda"])
    dp_zero_counts()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with ctx.redirect_stdout(printed):
        rows = recompute_eval_metrics.recompute(args)
    seconds = time.perf_counter() - t0
    counted = dp_counts()
    _add_launches(launches, counted)
    for line in printed.getvalue().splitlines():
        log(f"tools: recompute_eval_metrics row: {line}")
    keys = ("eval/psnr", "eval/ssim", "eval/lpips_judge_default", "eval/lpips_judge_alt_lpips")
    if [r["step"] for r in rows] != [1, 3] or any(
            not np.isfinite(r[k]) for r in rows for k in keys) or any(
            r[k] < 0 for r in rows for k in keys[2:]) \
            or counted["gn"] != len(rows) * TOOLS_EVAL_BATCHES * JOB_GN:
        raise AssertionError(f"tools: recompute_eval_metrics rows {rows}, launches {counted}")
    log(f"tools: recompute_eval_metrics over phase 43's {len(rows)} checkpoints, "
        f"{TOOLS_EVAL_BATCHES} x {TOOLS_EVAL_BATCH} PNG images, 2 judges: {seconds:.1f} s, "
        f"launches {counted}")
    return {"launches": launches}


def dp_timing_lines(card: str, steps: dict, jobs: dict) -> None:
    """Phases 38-41's readings, each line with the card's name and power
    limit: ms a step at world size 1 and 2 (CUDA events on each rank's
    stream; two ranks time-slice one card, so this is no scaling figure),
    the bytes of each step's gradient all-reduces (D's, then G's) and their
    time (host clock between syncs), each rank's peak memory."""
    for name, ref in steps["ref"].items():
        log(f"[{card}] data parallel {name}: world size 1 (global batch): step 2 "
            f"{ref['ms'][-1]:.1f} ms by events ({ref['host_ms'][-1]:.1f} host), peak "
            f"{ref['peak_bytes'] / 2**30:.3f} GiB")
        for backend in ("gloo", "nccl"):
            for r in steps.get(backend, ()):
                got = r["cases"].get(name)
                if got is None:
                    continue
                last = got["reduces"][-len(got["reduces"]) // DP_STEPS:]
                log(f"[{card}] data parallel {name}: world size {DP_RANKS} over {backend}, rank "
                    f"{r['rank']} on {r['device']}: step 2 {got['ms'][-1]:.1f} ms by events "
                    f"({got['host_ms'][-1]:.1f} host); gradient all-reduces a step " + ", ".join(
                        f"{b / 2**20:.1f} MiB in {t * 1e3:.1f} ms" for b, t in last)
                    + f"; peak {got['peak_bytes'] / 2**30:.3f} GiB")
    for tag in ("first", "fsdp_first", "resume", "nccl"):
        for r in jobs[tag]:
            log(f"[{card}] {r['name']} ({tag}, mesh {r['mesh']}, {r['backend']}, "
                f"rank {r['rank']}): {r['step_ms']:.1f} ms a step by the host clock, "
                f"{r['device_step_ms']:.1f} by events; eval "
                f"{', '.join(f'{t:.2f}' for t in r['evals']) or 'none'} s; save "
                f"{', '.join(f'{t:.2f}' for t in r['saves'])} s; peak "
                f"{r['peak_bytes'] / 2**30:.3f} GiB; the launch {r['seconds']:.1f} s")


# phases 45-48: the context mesh axis of the 3D job (parallel/context.py):
# ``--mesh_shape data=1,context=2``, two ranks sharing the card over gloo,
# each holding half of every clip's T frames

CTX_RANKS = 2
CTX_MESH = {"data": 1, "context": CTX_RANKS}
# phase 45: ring attention at the mid blocks, (B, N, H, D, dtype): the long
# clip's (48 x 256 px at ch 64, ch_mult 1,2,4: 12 x 64 x 64 tokens of 256
# channels, phase 13's "long clip" case) and TVAEConfig()'s at 16f/128px (2 x
# 16 x 16 tokens of 256 channels, batch 2) in bf16, and in fp32 as phase 47's
# step runs it; each rank holds half the tokens
RING_CASES = {"48f/256px mid block": (1, 49152, 8, 32, torch.bfloat16),
              "16f/128px mid block": (2, 512, 8, 32, torch.bfloat16),
              "16f/128px mid block fp32": (2, 512, 8, 32, torch.float32),
              # phase 50's: the flagship's 32 x 32 latent tokens at batch 8, 16
              # heads of 64, each rank 16 rows of them
              "flagship mid block": (DP_BATCH, 1024, 16, 64, torch.bfloat16)}
RING_FWD_CASE, RING_BWD_CASE = "48f/256px mid block", "16f/128px mid block fp32"
RING_2D_CASE = "flagship mid block"
# phase 47: phase 40's 3D GAN step (TVAEConfig()'s width in fp32, 16f/128px,
# 2 clips, hinge + LeCam on 4 frames) with the frame D and with the tubelet D
CTX_CASES = ("3d gan", "3d gan tubelet")
# phase 48: phase 28's GAN job at data=1,context=2 (3 steps, an eval after
# step 1 and at the end, saves after step 1 and at the end; run by phases
# 45-47's ranks after them, which saves a torchrun launch's ~25 s of process
# and CUDA start), then its save resumed in one plain process for a fourth
# step
CTX_JOB = TRAIN3D_JOB + TRAIN3D_GAN
CTX_JOB_FIRST = ["--mesh_shape", "data=1,context=2", "--max_steps", "3",
                 "--evaluate_every_n_steps", "3"]
CTX_JOB_RESUME = ["--mesh_shape", "data=1", "--max_steps", "4", "--evaluate_every_n_steps",
                  "0"]
# phases 49-51: the context axis of the 2D job, each image's H rows split over
# phases 45-48's two ranks (in their launch). Phase 50: phase 38's flagship
# step (bf16, batch 8, hinge + LeCam, clamp) with the latent flips and crop
# bucket CTX2D_CROP (0.75: 24 of 32 latent rows, 12 a rank, and 192 of the
# target's 256 rows, 96 a rank: six whole VGG strides, so LPIPS and D run on
# the blocks), and with phase 16's mid-block attention uncropped (a crop's
# 576 tokens do not split into its 512-token chunks, which the one-rank run
# needs); D's accuracy is held to one logit of the crop's 12 x 12 patch grid
CTX2D_CASES = ("flagship ctx", "flagship attn ctx", "flagship ctx fp32")
# phase 50's bf16 cases: their step-1 losses are held to phase 8's bounds,
# their gradients logged as PERF.md §7's witness (``ctx2d_bf16_witness``),
# "flagship ctx"'s beside bf16's own rounding of the one-rank step
# (CTX2D_WITNESS); the fp32 case holds the step to phase 8's bounds
CTX2D_BF16 = ("flagship ctx", "flagship attn ctx")
CTX2D_WITNESS = "flagship ctx"
CTX2D_CROP = 1
CTX2D_LOGITS = 2 * DP_BATCH * 144
# phase 49: halo at the flagship's widest rank block (batch 8, 128 of 256
# rows, 256 channels, bf16), forward and backward, against the whole
# zero-padded tensor's slices
CTX2D_HALO = (DP_BATCH, 256, 256, 256)
# phase 51: phase 26's flagship job (TRAIN_JOB) at data=1,context=2 for 3
# steps (an eval after step 1, saves after step 1 and at the end), then its
# save resumed at data=1 in one plain process for a fourth step
CTX2D_JOB_FIRST = ["--mesh_shape", "data=1,context=2", "--max_steps", "3",
                   "--evaluate_every_n_steps", "3"]
CTX2D_JOB_RESUME = ["--mesh_shape", "data=1", "--max_steps", "4", "--evaluate_every_n_steps",
                    "0"]


def _ring_chunk(n: int) -> int:
    """The plain version's k/v chunk for a block of ``n`` tokens."""
    return n if n <= 1024 else 1024


def ring_check(group, rank: int) -> dict:
    """Phase 45 in a rank: for each of ``RING_CASES`` the ring over
    ``group`` on this rank's half of seeded global q, k, v and cotangent g
    (the same on every rank), forward and backward through autograd, twice,
    the second run timed by CUDA events on each rank (the ranks time-slice
    the card; the first pays the collectives' and kernels' first use). Rank
    0 then holds the joined out, dq, dk, dv against one rank's kernel #3
    over the whole sequence: within twice ``rounding_bounds`` at ATTN_RTOL
    (both sides round their sums), plus, in bf16, one bf16 ulp of the value
    for the output's cast (phase 13's rule; the ring's partials stay fp32
    until then). At the ring's block (the local queries against one
    visiting block) it holds the launch the ring makes, kernel #3 with fp32
    outputs, forward and backward, against its plain version's fp32 sums
    within ``rounding_bounds`` alone, and times it, its plain version, SDPA
    and the bound, by device time, the other rank waiting. Returns rank 0's
    results by case."""
    from vqgan_tpu_torch.ops import attention_cuda as ac
    from vqgan_tpu_torch.ops import ring_attention as ring
    from vqgan_tpu_torch.ops.attention import (
        chunked_attention_backward,
        chunked_attention_forward,
        rounding_bounds,
    )
    from vqgan_tpu_torch.parallel.context import owned_blocks
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms
    import torch.distributed as dist

    f32 = torch.float32
    out = {}
    for name, (b, n, h, d, dtype) in RING_CASES.items():
        bf16 = dtype == torch.bfloat16
        gen = torch.Generator(device="cuda").manual_seed(45)
        q, k, v, g = (torch.randn((b, n, h, d), generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        nl, chunk = n // CTX_RANKS, _ring_chunk(n // CTX_RANKS)
        blk = slice(rank * nl, (rank + 1) * nl)
        for _ in range(2):
            ql, kl, vl = (t[:, blk].detach().requires_grad_() for t in (q, k, v))
            dist.barrier(group)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            o = ring.ring_attention(ql, kl, vl, group, chunk)
            ev[1].record()
            o.backward(g[:, blk].contiguous())
            ev[2].record()
            torch.cuda.synchronize()
        res = {"ring_fwd_ms": ev[0].elapsed_time(ev[1]), "ring_bwd_ms": ev[1].elapsed_time(ev[2])}
        blocks = owned_blocks([o.detach(), ql.grad, kl.grad, vl.grad], group)
        del o, ql, kl, vl
        if rank == 0:
            got = dict(zip(("out", "dq", "dk", "dv"),
                           (torch.cat([blocks[r][i] for r in range(CTX_RANKS)], dim=1)
                            for i in range(4))))
            del blocks
            ro, rlse = ac.attention_forward(q, k, v, chunk)
            want = dict(zip(("out", "dq", "dk", "dv"),
                            (ro, *ac.attention_backward(q, k, v, ro, rlse, g, chunk))))
            delta = (g.float() * ro.float()).sum(-1).transpose(1, 2)
            bounds = rounding_bounds(q, k, v, rlse, ATTN_RTOL, bf16, g, delta)
            shares, errs = {}, {}
            for key, w in want.items():
                diff = (got[key].float() - w.float()).abs()
                tol = 2 * bounds[key] + 1e-7
                if bf16:
                    tol = tol + 2.0 ** -7 * w.float().abs()
                shares[key], errs[key] = float((diff / tol).max()), float(diff.max())
            del got, want, bounds, delta, diff, tol
            # the ring's launch at its block (fp32 outputs), against its plain
            # version's fp32 sums, and timed beside them and SDPA
            qb, kb, vb, gb = (t[:, :nl] for t in (q, k, v, g))
            ob, lseb = ac.attention_forward(qb, kb, vb, chunk, out_dtype=f32)
            pob, plseb = chunked_attention_forward(qb, kb, vb, chunk, out_dtype=f32)
            narrow = pob.to(dtype)  # the out the ring's backward is given
            grads = ac.attention_backward(qb, kb, vb, narrow, plseb, gb, chunk, grad_dtype=f32)
            pgrads = chunked_attention_backward(qb, kb, vb, narrow, plseb, gb, chunk,
                                                grad_dtype=f32)
            delta = (gb.float() * narrow.float()).sum(-1).transpose(1, 2)
            bounds = rounding_bounds(qb, kb, vb, plseb, ATTN_RTOL, bf16, gb, delta)
            block = {}
            for key, got_b, want_b in zip(("out", "dq", "dk", "dv"), (ob, *grads),
                                          (pob, *pgrads)):
                if got_b.dtype != f32:
                    raise AssertionError(f"ring attention {name}: the block's {key} is "
                                         f"{got_b.dtype}, not fp32")
                block[key] = float(((got_b - want_b).abs() / (bounds[key] + 1e-7)).max())
            del grads, pgrads, bounds, delta
            iters = 2 if nl > 4096 else 20
            times = {
                "fwd": (device_ms(lambda: ac.attention_forward(qb, kb, vb, chunk, out_dtype=f32),
                                  iters),
                        device_ms(lambda: chunked_attention_forward(qb, kb, vb, chunk,
                                                                    out_dtype=f32), iters),
                        device_ms(lambda: _library_attention(qb, kb, vb), iters),
                        attention_bound_ms(b, nl, h, d, dtype, backward=False))}
            if name in (RING_BWD_CASE, RING_2D_CASE):
                lf_ms = times["fwd"][2]
                ql, kl, vl = (t.detach().requires_grad_() for t in (qb, kb, vb))

                def fwd_bwd():
                    torch.autograd.grad(_library_attention(ql, kl, vl), (ql, kl, vl),
                                        gb.transpose(1, 2))

                times["bwd"] = (
                    device_ms(lambda: ac.attention_backward(qb, kb, vb, narrow, plseb, gb, chunk,
                                                            grad_dtype=f32), iters),
                    device_ms(lambda: chunked_attention_backward(qb, kb, vb, narrow, plseb, gb,
                                                                 chunk, grad_dtype=f32), iters),
                    device_ms(fwd_bwd, iters) - lf_ms,
                    attention_bound_ms(b, nl, h, d, dtype, backward=True))
            res.update(shares=shares, errs=errs, block=block, times=times)
            log(f"ring attention {name} (B={b} N={n} H={h} D={d} {str(dtype)[6:]}, "
                f"{CTX_RANKS} ranks of {nl} tokens): against one rank's kernel #3 over the "
                f"whole sequence max_abs_err " + " ".join(f"{k_}={v_:.3e}" for k_, v_ in
                                                            errs.items())
                + "; share of the bound used " + " ".join(f"{k_}={v_:.3f}" for k_, v_ in
                                                          shares.items())
                + "; the ring's launch at its block (fp32 outputs) against plain, share of "
                "rounding_bounds used " + " ".join(f"{k_}={v_:.3f}" for k_, v_ in block.items())
                + f"; the ring on rank 0 {res['ring_fwd_ms']:.3f} ms forward, "
                f"{res['ring_bwd_ms']:.3f} ms backward (CUDA events, both ranks on the card); "
                f"kernel #3 at the block: " + "; ".join(
                    f"{kind} kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
                    f"bound_ms={t[3]:.4f}" for kind, t in times.items()))
            if any(s_ > 1.0 for s_ in (*shares.values(), *block.values())):
                raise AssertionError(f"ring attention {name}: outside its bound: {shares}, "
                                     f"at the block {block}")
            out[name] = res
            del ro, rlse, qb, kb, vb, gb, ob, lseb, pob, plseb, narrow
        del q, k, v, g
        torch.cuda.empty_cache()
        dist.barrier(group)
    return out


def gn_two_pass_check(gn, x, g, w, b, swish: bool, label: str) -> dict:
    """Kernels #1 and #2 in their two-pass form (one rank, no group)
    against their plain versions on (x, g): the forward sums and the
    backward's group sums, dγ and dβ within SUM_RTOL of Σ|terms|; y (from
    the kernel's stats) within ATOL_FP32 or one bf16 ulp; dx within ATOL_DX
    or one bf16 ulp; and against the one-launch kernels within twice those
    (each side lies within them of the plain version); every launch
    bitwise repeatable. Times are the device's (CUDA graph replays) for
    each launch, its plain version and, for the apply and dx launches,
    F.group_norm's forward and backward (library); each bound counts what
    the launch must read and write once. Returns {launch: (max_abs_err,
    kernel_ms, plain_ms, library_ms or None, bound_ms)}."""
    from vqgan_tpu_torch.ops import normalization as plain
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    c = x.shape[1]
    count = x[0, 0].numel() * (c // 32)
    bf16 = x.dtype == torch.bfloat16
    sums = gn.group_norm_partial_sums(x, 32)
    stats = plain.group_norm_stats_from_sums(sums, count, 1e-6)
    y = gn.group_norm_apply(x, stats, w, b, 32, swish)
    gs, dw, db = gn.group_norm_backward_partial(x, g, stats, w, b, 32, swish)
    dx = gn.group_norm_backward_dx(x, g, stats, gs, count, w, b, 32, swish)
    again = (gn.group_norm_partial_sums(x, 32), gn.group_norm_apply(x, stats, w, b, 32, swish),
             *gn.group_norm_backward_partial(x, g, stats, w, b, 32, swish),
             gn.group_norm_backward_dx(x, g, stats, gs, count, w, b, 32, swish))
    same = all(torch.equal(p, q) for p, q in zip((sums, y, gs, dw, db, dx), again))
    del again
    psums = plain.group_norm_partial_sums(x, 32)
    py = plain.group_norm_apply(x, stats, w, b, 32, swish)
    pgs, pdw, pdb = plain.group_norm_backward_partial(x, g, stats, w, b, 32, swish)
    pdx = plain.group_norm_backward_dx(x, g, stats, gs, count, w, b, 32, swish)
    y1, stats1 = gn.group_norm_forward(x, w, b, 32, 1e-6, swish)
    dx1, dw1, db1 = gn.group_norm_backward(x, g, stats1, w, b, 32, swish)
    torch.cuda.synchronize()
    # Σ|terms|: of the sums, and (|dŷ| <= 1.1·|g| with the swish) of the backward's
    xf = x.float()
    xa = xf.abs().movedim(1, -1).reshape(x.shape[0], -1, 32, c // 32)
    t_sums = torch.stack([xa.sum(dim=(1, 3)), xa.square().sum(dim=(1, 3))], dim=1)
    ga = 1.1 * g.float().abs()
    mean_c = stats[:, 0].repeat_interleave(c // 32, dim=-1)
    rstd_c = stats[:, 1].repeat_interleave(c // 32, dim=-1)
    shape = (x.shape[0], c) + (1,) * (x.ndim - 2)
    xh = ((xf - mean_c.view(shape)) * rstd_c.view(shape)).abs()
    dims = tuple(range(2, x.ndim))
    t0 = (ga.sum(dim=dims) * w.abs()).view(x.shape[0], 32, -1).sum(-1)
    t1 = ((ga * xh).sum(dim=dims) * w.abs()).view(x.shape[0], 32, -1).sum(-1)
    t_dw, t_db = (ga * xh).sum(dim=(0, *dims)), ga.sum(dim=(0, *dims))
    del xf, xa, ga, xh

    def within_sum(got, want, terms):
        return bool(((got - want).abs() <= SUM_RTOL * terms + 1e-6).all())

    def within_ulp(got, want, atol, times=1):
        diff = (got.float() - want.float()).abs()
        if bf16:
            return bool((diff <= times * (atol + RTOL_BF16 * want.float().abs())).all())
        return float(diff.max()) <= times * atol

    checks = {
        "sums": within_sum(sums, psums, t_sums),
        "y": within_ulp(y, py, 1e-6 if bf16 else ATOL_FP32),
        "y one-launch": within_ulp(y, y1, 1e-6 if bf16 else ATOL_FP32, 2),
        "gsums": within_sum(gs, pgs, torch.stack([t0, t1], dim=1)),
        "dgamma": within_sum(dw, pdw, t_dw), "dbeta": within_sum(db, pdb, t_db),
        "dgamma one-launch": within_sum(dw, dw1, 2 * t_dw),
        "dbeta one-launch": within_sum(db, db1, 2 * t_db),
        "dx": within_ulp(dx, pdx, ATOL_DX),
        "dx one-launch": within_ulp(dx, dx1, ATOL_DX, 2),
        "bitwise repeat": same,
    }
    errs = {"sums": float((sums - psums).abs().max()),
            "apply": float((y.float() - py.float()).abs().max()),
            "bwd_sums": max(float((gs - pgs).abs().max()), float((dw - pdw).abs().max()),
                            float((db - pdb).abs().max())),
            "dx": float((dx.float() - pdx.float()).abs().max())}
    del psums, py, pgs, pdw, pdb, pdx, y1, dx1
    iters = 3 if x.numel() * 4 > 2**29 else 20
    es = x.element_size()
    xl = x.detach().requires_grad_()
    wl, bl = (t.detach().to(x.dtype).requires_grad_() for t in (w, b))
    lf_ms = device_ms(lambda: _library_forward(xl, wl, bl, swish), iters)
    lfb_ms = device_ms(lambda: torch.autograd.grad(_library_forward(xl, wl, bl, swish),
                                                   (xl, wl, bl), g), iters)
    del xl, wl, bl
    out = {
        "sums": (errs["sums"], device_ms(lambda: gn.group_norm_partial_sums(x, 32), 20),
                 device_ms(lambda: plain.group_norm_partial_sums(x, 32), iters), None,
                 bound_ms(x.numel() * es)),
        "apply": (errs["apply"],
                  device_ms(lambda: gn.group_norm_apply(x, stats, w, b, 32, swish), 20),
                  device_ms(lambda: plain.group_norm_apply(x, stats, w, b, 32, swish), iters),
                  lf_ms, bound_ms(2 * x.numel() * es)),
        "bwd_sums": (errs["bwd_sums"],
                     device_ms(lambda: gn.group_norm_backward_partial(x, g, stats, w, b, 32,
                                                                      swish), 20),
                     device_ms(lambda: plain.group_norm_backward_partial(x, g, stats, w, b, 32,
                                                                         swish), iters),
                     None, bound_ms(2 * x.numel() * es)),
        "dx": (errs["dx"],
               device_ms(lambda: gn.group_norm_backward_dx(x, g, stats, gs, count, w, b, 32,
                                                           swish), 20),
               device_ms(lambda: plain.group_norm_backward_dx(x, g, stats, gs, count, w, b, 32,
                                                              swish), iters),
               lfb_ms - lf_ms, bound_ms(3 * x.numel() * es)),
    }
    name = "bf16" if bf16 else "fp32"
    ok = all(checks.values())
    log(f"gn two-pass {label} {name} swish={int(swish)}: max_abs_err " + " ".join(
        f"{k_}={v_[0]:.3e}" for k_, v_ in out.items()) + "; device ms (kernel/plain/library/"
        "bound) " + "; ".join(
            f"{k_} {v_[1]:.4f}/{v_[2]:.4f}/{'-' if v_[3] is None else f'{v_[3]:.4f}'}/"
            f"{v_[4]:.4f}" for k_, v_ in out.items())
        + f"; {'ok' if ok else 'MISS ' + str([k_ for k_, v_ in checks.items() if not v_])}")
    if not ok:
        raise AssertionError(f"two-pass GroupNorm at {label} {name} swish={swish}: {checks}")
    return out


def gn_two_pass_at_shapes(gn, shapes: list, label: str) -> dict:
    """Phases 46 and 49: ``gn_two_pass_check`` at each (B, C, T, H, W,
    dtype, swish, calls), or (B, C, H, W, ...) for a 2D step, of ``shapes``
    (a context rank's GroupNorms of one step of a path, as its hooks
    recorded them: ``gn_shape_rows``); returns per launch the largest
    max_abs_err and the (kernel, plain, library, bound) ms summed over the
    step's calls."""
    gen = torch.Generator(device="cuda").manual_seed(46)
    total = {}
    for b, c, *spatial, dtype, swish, calls in shapes:
        dt = getattr(torch, dtype)
        x, wt, bs = _gn_inputs(gen, b, 0, c, dt, tuple(spatial))
        g = _gn_inputs(gen, b, 0, c, dt, tuple(spatial))[0] - 0.3
        res = gn_two_pass_check(gn, x, g, wt, bs, swish, f"B={b} C={c} " + " ".join(
            f"{n_}={v_}" for n_, v_ in zip("THW"[-len(spatial):], spatial)))
        for launch, (err, *ms) in res.items():
            acc = total.setdefault(launch, [0.0, 0.0, 0.0, 0.0, 0.0])
            acc[0] = max(acc[0], err)
            for i, v in enumerate(ms):
                acc[i + 1] = None if v is None or acc[i + 1] is None else acc[i + 1] + calls * v
        del x, g
        torch.cuda.empty_cache()
    calls = sum(s[-1] for s in shapes)
    log(f"GN two-pass at a context rank's step of {label} ({calls} calls a launch, device "
        f"time, kernel/plain/library/bound ms): " + "; ".join(
            f"{k_} " + "/".join("-" if v_ is None else f"{v_:.4f}" for v_ in acc[1:])
            for k_, acc in total.items()))
    return {k_: tuple(v_) for k_, v_ in total.items()}


def halo_h_check(group, rank: int) -> dict:
    """Phase 49's halo in a rank: ``halo`` (one row each way) on this
    rank's half of the rows of a seeded bf16 (B, C, H, W) tensor of
    ``CTX2D_HALO``, forward and backward through autograd for seeded
    cotangents (every rank's drawn on every rank), twice, the second timed
    by CUDA events (both ranks on the card): the output must be the slice
    of the whole zero-padded tensor, and the input's gradient this rank's
    rows of the sum of every rank's cotangent at its place, bit for bit.
    Returns the ms and the bytes a rank sends."""
    import torch.distributed as dist

    from vqgan_tpu_torch.parallel.context import halo

    b, c, h, w = CTX2D_HALO
    hl = h // CTX_RANKS
    gen = torch.Generator(device="cuda").manual_seed(49)

    def channels_last(t):  # (B, H, W, C) → (B, C, H, W) channels_last, bf16
        return t.to(torch.bfloat16).movedim(-1, 1)

    x = channels_last(torch.randn((b, h, w, c), generator=gen, device="cuda"))
    cots = [channels_last(torch.randn((b, hl + 2, w, c), generator=gen, device="cuda"))
            for _ in range(CTX_RANKS)]
    for _ in range(2):
        xl = x[:, :, rank * hl:(rank + 1) * hl].contiguous(
            memory_format=torch.channels_last).requires_grad_()
        dist.barrier(group)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        y = halo(xl, 1, 1, group)
        ev[1].record()
        y.backward(cots[rank])
        ev[2].record()
        torch.cuda.synchronize()
    pad = F.pad(x, (0, 0, 1, 1))
    dpad = torch.zeros_like(pad, dtype=torch.float32)
    for r, cot in enumerate(cots):
        dpad[:, :, r * hl:r * hl + hl + 2] += cot.float()
    want_dx = dpad[:, :, 1 + rank * hl:1 + (rank + 1) * hl].to(torch.bfloat16)
    same = (torch.equal(y.detach(), pad[:, :, rank * hl:rank * hl + hl + 2])
            and torch.equal(xl.grad, want_dx))
    if not same:
        raise AssertionError(f"halo rank {rank}: not the whole tensor's slices")
    return {"fwd_ms": ev[0].elapsed_time(ev[1]), "bwd_ms": ev[1].elapsed_time(ev[2]),
            "bytes": w * c * b * 2 * (2 if 0 < rank < CTX_RANKS - 1 else 1)}


def ctx_ranks_main(spec_path: str) -> int:
    """One rank of phases 45-51 (``chip_smoke.py --ctx-ranks SPEC`` under
    torchrun): joins the process group on ``CTX_MESH``; phase 45 on both
    ranks (``ring_check``) and phase 49's halo (``halo_h_check``); phase 47:
    each of ``CTX_CASES`` on this rank's half of every clip's frames, and
    phase 50: each of ``CTX2D_CASES`` on this rank's half of every image's
    rows, its model and step built with the context group, replaying the
    one-rank run's loss-head decisions (a 2D rank its block of rows of
    them), the ranks' states compared bit for bit after each step, each
    step's launches, CUDA-event ms and peak memory recorded, the model's
    GroupNorm shapes recorded by hooks; phases 48 and 51: the spec's jobs
    (``rank_jobs``, their steps' GroupNorm shapes recorded); then phases 46
    and 49 on rank 0 while the other waits: the two-pass launches at the
    GroupNorm shapes of phase 47's step (fp32), of phase 48's (bf16) and of
    phase 50's flagship step (bf16) (``gn_two_pass_at_shapes``). cuDNN
    deterministic, its benchmark off, TF32 convolutions as the spec says.
    Writes its results to ``{dir}/ctx_rank{r}.pt``."""
    import torch.distributed as dist

    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.parallel.mesh import create_mesh, init_distributed, replicas_equal
    from vqgan_tpu_torch.train.state import state_tensors

    with open(spec_path) as f:
        spec = json.load(f)
    for cfg in (spec["models"]["vae"], spec["models"]["tvae"]):  # JSON's lists: tuples
        cfg.update({k: tuple(v) for k, v in cfg.items() if isinstance(v, list)})
    device = init_distributed("cuda")
    mesh = create_mesh(CTX_MESH)
    group = mesh.context_group
    set_tf32(spec["tf32"])
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {"rank": mesh.rank, "device": str(device), "mesh": mesh.shape,
           "backend": dist.get_backend(group), "cases": {}}
    t0 = time.perf_counter()
    out["ring"] = ring_check(group, mesh.rank)
    t49 = time.perf_counter()
    out["halo"] = halo_h_check(group, mesh.rank)
    t47 = time.perf_counter()
    out["cases2d"] = {}
    for name in CTX_CASES + CTX2D_CASES:
        case = dp_case(name, device, group, spec["models"], context=group)
        t = case["batch"].shape[1] // CTX_RANKS
        case["batch"] = case["batch"][:, mesh.context_index * t:(mesh.context_index + 1) * t]
        tape = DecisionTape()
        tape.calls = torch.load(os.path.join(spec["dir"], f"ctx_tape_{name.replace(' ', '_')}.pt"),
                                weights_only=True)
        if name in CTX2D_CASES:  # the loss head sees this rank's rows
            tape = tape.rows(0, 1, (mesh.context_index, CTX_RANKS))
        equal = []

        def after_step(state):
            equal.append(replicas_equal(state_tensors(state), group))

        shapes, hooks = record_gn_shapes(case["model"])
        try:
            got = dp_run_case(case, slice(None), tape, record=False, after_step=after_step)
        finally:
            for h in hooks:
                h.remove()
        got["replicas_equal"] = equal
        got["gn_shapes"] = gn_shape_rows(shapes, DP_STEPS)
        if mesh.rank != 0:
            got.pop("moments", None)
            got.pop("extra", None)
        out["cases2d" if name in CTX2D_CASES else "cases"][name] = got
        del case, tape
        gc.collect()
        torch.cuda.empty_cache()
        if name == CTX_CASES[-1]:
            t50 = time.perf_counter()
    t48 = time.perf_counter()
    out["jobs"] = rank_jobs(spec["jobs"])
    t46 = time.perf_counter()
    if mesh.rank == 0:
        job = out["jobs"][0]
        out["gn"] = {
            "step": gn_two_pass_at_shapes(gn, out["cases"]["3d gan"]["gn_shapes"],
                                          "phase 47's 3d gan (fp32)"),
            "job": gn_two_pass_at_shapes(gn, job["gn_shapes"], "phase 48's job (bf16)"),
            "step2d": gn_two_pass_at_shapes(gn, out["cases2d"]["flagship ctx"]["gn_shapes"],
                                            "phase 50's flagship step (bf16)")}
    dist.barrier(group)
    out["seconds"] = {"45": t49 - t0, "49 halo": t47 - t49, "47": t50 - t47, "50": t48 - t50,
                      "48 and 51": t46 - t48, "46 and 49": time.perf_counter() - t46}
    torch.save(out, os.path.join(spec["dir"], f"ctx_rank{mesh.rank}.pt"))
    dist.destroy_process_group()
    return 0


def grad_shares(ref: dict, got: dict) -> dict:
    """Each step-1 first moment's distance from ``ref``'s as a share of
    phase 8's gradient bound (GRAD_RTOL of the tensor's largest entry +
    GRAD_FLOOR of the largest entry of its side), {side: {name: share}}."""
    out = {}
    for side in ("G", "D"):
        r_side, o_side = ref[side], got[side]
        floor = GRAD_FLOOR * max(float(t.abs().max()) for t in r_side.values())
        out[side] = {n: float((o_side[n] - r).abs().max()) / (GRAD_RTOL * float(r.abs().max())
                                                               + floor)
                     for n, r in r_side.items()}
    return out


def ctx2d_bf16_witness(what: str, one: dict, one_fp32: dict | None, ranks_run: dict,
                       n_logits: int) -> None:
    """Phase 50's bf16 step against one rank: step 1's losses within phase
    8's bounds (raises on a miss). Its gradients are not held: the bf16 step
    at the rank's half images is a second bf16 rounding of the one-rank
    step (PERF.md §7's witness), and the fp32 case holds the step's
    gradients to phase 8's bounds. Logs each side's gradient shares of that
    bound, and, with ``one_fp32`` (the same one-rank step in fp32 replaying
    its decisions), bf16's own rounding of each tensor past it."""
    worst_loss, _, bad_loss, _ = step_bound_shares(
        (one["metrics"][0], one["moments"]), (ranks_run["metrics"][0], ranks_run["moments"]),
        n_logits)
    gap = grad_shares(one["moments"], ranks_run["moments"])
    own = grad_shares(one["moments"], one_fp32["moments"]) if one_fp32 else None
    for side in ("G", "D"):
        past = {n: s_ for n, s_ in gap[side].items() if s_ > 1.0}
        worst = max(gap[side], key=gap[side].get)
        log(f"train cross-device {what}, step 1 against one rank on whole images, {side} "
            f"(witness, not held): the worst gradient {worst} uses {gap[side][worst]:.3f} of "
            f"phase 8's bound ({len(past)} of {len(gap[side])} tensors past it"
            + ("" if own is None else ": " + ", ".join(
                f"{n} {s_:.3f} (bf16's own rounding {own[side][n]:.3f})"
                for n, s_ in sorted(past.items(), key=lambda kv: -kv[1])[:6]))
            + ")" + ("" if own is None else
                     f"; bf16's own rounding, the one-rank step against fp32: worst "
                     f"{max(own[side].values()):.3f}, "
                     f"{sum(s_ > 1 for s_ in own[side].values())} tensors past the bound"))
    log(f"train cross-device {what}: the worst loss uses {worst_loss:.3f} of its bound")
    if bad_loss:
        raise AssertionError(f"{what}: step 1's losses leave phase 8's bounds: {bad_loss}")


def phase_context_steps(tmp: str) -> dict:
    """Phases 45-47 and 49-50: each of ``CTX_CASES`` and ``CTX2D_CASES`` at
    one rank on the whole clips or images, recording the loss head's
    decisions, then one torchrun launch of ``CTX_RANKS`` ranks on the card
    over gloo (``ctx_ranks_main``): phase 45's ring attention, phase 49's
    halo, phase 47's and phase 50's steps at ``CTX_MESH``, phases 48 and
    51's jobs (``phase_context_job`` checks them), then phases 46 and 49's
    two-pass GroupNorm at the shapes phase 47's, phase 48's and phase 50's
    steps ran it (their hooks'). Phase 50 holds what phase 47 holds, the
    GroupNorms and the ring by the same rule, no Conv3d, and step 1 against
    D's accuracy of the crop's patch grid (``CTX2D_LOGITS``); of its bf16
    cases, step 1's losses (``ctx2d_bf16_witness``).
    Phase 47 holds: the ranks' states bitwise equal after
    every step, the same metrics on both; step 1 within phase 8's bounds of
    the one-rank step (``compare_step_across_devices``); each rank's
    launches a step: the one-rank run's GroupNorms all in the two-pass
    form (sums, apply, backward sums, dx), none one-launch, kernel #3
    CTX_RANKS times a one-rank call (the ring), #6 and its dx the one-rank
    run's (on halo-extended blocks); the GroupNorm calls its hooks recorded,
    the two-pass launches a step, the same for both D. Returns the ranks'
    results and launches."""
    set_tf32(True)
    tf32 = torch.backends.cudnn.allow_tf32
    ref = {}
    for name in CTX_CASES + CTX2D_CASES:
        case = dp_case(name, "cuda")
        tape = DecisionTape()
        ref[name] = dp_run_case(case, slice(None), tape, record=True)
        torch.save(tape.calls, os.path.join(tmp, f"ctx_tape_{name.replace(' ', '_')}.pt"))
        log(f"context {name}: the one-rank run on whole "
            f"{'images' if name in CTX2D_CASES else 'clips'} recorded {tape.describe()}; "
            f"launches a step {ref[name]['launches']}")
        if name == CTX2D_WITNESS:
            # bf16's own rounding: the same one-rank step in fp32 with these
            # decisions replayed
            del case
            gc.collect()
            torch.cuda.empty_cache()
            case = dp_case(name, "cuda", fp32=True)
            ref[f"{name} fp32 replay"] = dp_run_case(case, slice(None), tape, record=False)
        del case, tape
        gc.collect()
        torch.cuda.empty_cache()
    job = {"name": "context job", "expect": "", "digest_out": os.path.join(tmp, "digest_ctx.json"),
           "argv": CTX_JOB + ["--ckpt_dir", os.path.join(tmp, "ckpt"), "--run_name", "ctx"]
           + CTX_JOB_FIRST, "gn_shapes": True}
    job2d = {"name": "context 2d job", "expect": "",
             "digest_out": os.path.join(tmp, "digest_ctx2d.json"),
             "argv": TRAIN_JOB + ["--ckpt_dir", os.path.join(tmp, "ckpt"), "--run_name", "ctx2d"]
             + CTX2D_JOB_FIRST, "gn_shapes": True}
    spec = {"dir": tmp, "tf32": tf32, "models": dp_models(), "jobs": [job, job2d]}
    spec_path = os.path.join(tmp, "ctx_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env_cards = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "0" if env_cards is None else env_cards.split(",")[0]
    try:
        dp_launch([os.path.abspath(__file__), "--ctx-ranks", spec_path], CTX_RANKS,
                  os.path.join(tmp, "ctx_ranks.log"))
    finally:
        if env_cards is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = env_cards
    ranks = [torch.load(os.path.join(tmp, f"ctx_rank{r}.pt"), weights_only=False)
             for r in range(CTX_RANKS)]
    if [(r["mesh"], r["backend"]) for r in ranks] != [(CTX_MESH, "gloo")] * CTX_RANKS:
        raise AssertionError(f"context ranks: {[(r['mesh'], r['backend']) for r in ranks]}")
    launches: dict[str, int] = {}
    for name in CTX_CASES + CTX2D_CASES:
        two_d = name in CTX2D_CASES
        what = f"context {name} ({CTX_MESH}, gloo)"
        got = [r["cases2d" if two_d else "cases"][name] for r in ranks]
        one = ref[name]["launches"][0]
        want = {**{k_: 0 for k_ in one}, "gn_ctx_sums": one["gn"], "gn_ctx_apply": one["gn"],
                "gn_ctx_bwd_sums": one["gn_bwd"], "gn_ctx_dx": one["gn_bwd"],
                "ring": CTX_RANKS * one["attn"], "ring_bwd": CTX_RANKS * one["attn_bwd"],
                "attn": CTX_RANKS * one["attn"], "attn_bwd": CTX_RANKS * one["attn_bwd"],
                "conv3d": one["conv3d"], "conv3d_dx": one["conv3d_dx"],
                "nearest": one["nearest"], "stats": one["stats"]}
        for r, g_ in enumerate(got):
            if any(step != want for step in g_["launches"]):
                raise AssertionError(f"{what}: rank {r} launched {g_['launches']}, expected "
                                     f"{want} a step")
            if g_["replicas_equal"] != [True] * DP_STEPS:
                raise AssertionError(f"{what}: the ranks' states differ after the steps "
                                     f"{g_['replicas_equal']}")
            calls = sum(row[-1] for row in g_["gn_shapes"])
            # the 3D cases run one model; each 2D case its own
            shapes_of = (got[0] if two_d else ranks[0]["cases"]["3d gan"])["gn_shapes"]
            if calls != want["gn_ctx_sums"] or g_["gn_shapes"] != got[0]["gn_shapes"] \
                    or g_["gn_shapes"] != shapes_of:
                raise AssertionError(f"{what}: rank {r}'s GroupNorm shapes {g_['gn_shapes']} "
                                     f"({calls} calls a step)")
            for counted in g_["launches"]:
                _add_launches(launches, counted)
        if got[0]["metrics"] != got[1]["metrics"]:
            raise AssertionError(f"{what}: the ranks logged different metrics")
        log(f"{what}: each rank's launches a step {want}; after each of the {DP_STEPS} steps "
            f"every tensor of the ranks' train states bitwise equal")
        runs = {"cpu": (ref[name]["metrics"][0], ref[name]["moments"], ref[name]["extra"]),
                "cuda": (got[0]["metrics"][0], got[0]["moments"], got[0]["extra"])}
        if name in CTX2D_BF16:
            ctx2d_bf16_witness(what, ref[name], ref.get(f"{name} fp32 replay"), got[0],
                               CTX2D_LOGITS if name == "flagship ctx" else DP_CASES["flagship"])
        else:
            compare_step_across_devices(
                runs, f"{what}, step 1 against one rank on whole {'images' if two_d else 'clips'}",
                CTX2D_LOGITS if two_d else DP_CASES["3d gan"], 0,
                labels=("one rank", f"{CTX_RANKS} context ranks"))
        log(f"{what}: a step {np.mean(got[0]['ms']):.1f} / {np.mean(got[1]['ms']):.1f} ms by "
            f"CUDA events on ranks 0 / 1 (the one-rank run {np.mean(ref[name]['ms']):.1f} ms); "
            f"peak {got[0]['peak_bytes'] / 2**30:.3f} / {got[1]['peak_bytes'] / 2**30:.3f} GiB "
            f"a rank (one rank {ref[name]['peak_bytes'] / 2**30:.3f} GiB)")
    for name, r in ranks[0]["ring"].items():
        log(f"ring attention {name} ({CTX_RANKS} ranks, phase 45): against one rank's kernel #3 "
            f"over the whole sequence, max_abs_err " + " ".join(
                f"{k_}={v_:.3e}" for k_, v_ in r["errs"].items()) + "; share of the bound used "
            + " ".join(f"{k_}={v_:.3f}" for k_, v_ in r["shares"].items())
            + "; the ring's launch at its block (fp32 outputs) against plain, share of "
            "rounding_bounds used " + " ".join(f"{k_}={v_:.3f}" for k_, v_ in r["block"].items())
            + f"; the ring {r['ring_fwd_ms']:.3f} ms forward, {r['ring_bwd_ms']:.3f} ms backward "
            f"on rank 0 (CUDA events, both ranks on the card); kernel #3 at the block " + "; ".join(
                f"{kind} kernel_ms={t[0]:.4f} plain_ms={t[1]:.4f} library_ms={t[2]:.4f} "
                f"bound_ms={t[3]:.4f}" for kind, t in r["times"].items()))
    halo = [r["halo"] for r in ranks]
    b_, c_, h_, w_ = CTX2D_HALO
    log(f"halo (phase 49) at B={b_} C={c_} W={w_}, {h_ // CTX_RANKS} of {h_} rows a rank, bf16: "
        f"each rank's rows with a neighbour's row each way and the halos' gradients home, "
        f"bitwise the whole zero-padded tensor's; forward / backward "
        + ", ".join(f"rank {i} {r['fwd_ms']:.3f} / {r['bwd_ms']:.3f} ms" for i, r in
                    enumerate(halo))
        + f" by CUDA events (both ranks on the card, {halo[0]['bytes']} bytes sent a rank a "
        f"call, over gloo)")
    for path, label in (("step", "phase 47's 3d gan step (TVAEConfig() width, fp32)"),
                        ("job", "phase 48's job step (TVAEConfig() width, bf16)"),
                        ("step2d", "phase 50's flagship step (VAEConfig() width, bf16)")):
        log(f"GN two-pass (phases 46, 49) at the GroupNorms of a context rank's {label}, as its "
            f"hooks recorded them, every check within its bound; max_abs_err and device ms "
            f"summed over the step's calls (kernel/plain/library/bound): "
            + "; ".join(f"{k_} {v_[0]:.3e}, " + "/".join("-" if t is None else f"{t:.4f}"
                                                         for t in v_[1:])
                        for k_, v_ in ranks[0]["gn"][path].items()))
    log(f"context ranks: phase seconds in the launch {ranks[0]['seconds']}")
    return {"ref": ref, "ranks": ranks, "launches": launches, "ring": ranks[0]["ring"],
            "gn": ranks[0]["gn"]}


def phase_context_job(tmp: str, ctx_steps: dict) -> dict:
    """Phase 48: phase 28's job (``CTX_JOB``) at ``data=1,context=2``
    (``CTX_JOB_FIRST``), run by phases 45-47's ranks after them, sharing
    the card over gloo, each holding half of every clip's frames: 3 steps,
    rank 0 alone evaluating
    (whole clips, no group) after step 1 and at the end, logging and saving
    after step 1 and at the end; every rank's two-pass GroupNorm and ring
    launches 3 times phase 47's "3d gan" step's, no one-launch backward,
    and no one-launch forward but rank 0's evals'.
    Then one plain process resumes the step-3 save, bitwise the live state
    the ranks ended with (its ``state_digest``), and trains step 4 on whole
    clips. Returns the reports and launches."""
    import shutil

    digest = os.path.join(tmp, "digest_ctx.json")
    first = [r["jobs"][0] for r in ctx_steps["ranks"]]
    step_launches = ctx_steps["ranks"][0]["cases"]["3d gan"]["launches"][0]
    what = f"context job ({CTX_RANKS} ranks, {CTX_MESH})"
    seen = [(r["backend"], r["local_batch"], r["mesh"]) for r in first]
    if seen != [("gloo", JOB3D_BATCH, CTX_MESH)] * CTX_RANKS:
        raise AssertionError(f"{what}: (backend, local batch, mesh) {seen}")
    if [r["is_master"] for r in first] != [True, False] \
            or [len(r["evals"]) for r in first] != [2, 0]:
        raise AssertionError(f"{what}: rank 0 alone evaluates "
                             f"{[(r['is_master'], len(r['evals'])) for r in first]}")
    keys = ("gn_ctx_sums", "gn_ctx_apply", "gn_ctx_bwd_sums", "gn_ctx_dx", "ring", "ring_bwd")
    for r in first:
        per = r["launches"]
        if sum(row[-1] for row in r["gn_shapes"]) != step_launches["gn_ctx_sums"] \
                or r["gn_shapes"] != first[0]["gn_shapes"]:
            raise AssertionError(f"{what}: rank {r['rank']}'s GroupNorm shapes a step "
                                 f"{r['gn_shapes']}")
        if len(r["steps"]) != 3 or any(per[k] != 3 * step_launches[k] for k in keys) \
                or per["gn_bwd"] != 0 or (per["gn"] == 0) != (r["rank"] != 0):
            raise AssertionError(f"{what}: rank {r['rank']}: {len(r['steps'])} steps, "
                                 f"launches {per}, phase 47's a step {step_launches}")
    run_dir = os.path.join(tmp, "ckpt", "ctx")
    lines = job_lines(run_dir, "ctx")
    check_job_log(lines, range(0, 3), [0, 3], what, "loss", JOB3D_EVAL_KEYS)
    saved = sorted(os.listdir(os.path.join(run_dir, "state")))
    if saved != ["step_00000001.pt", "step_00000003.pt"]:
        raise AssertionError(f"{what}: saved {saved}")
    log(f"{what}: {first[0]['seconds']:.1f} s; ranks on {[r['device'] for r in first]} over "
        f"gloo, {JOB3D_BATCH} clips of {JOB3D_FRAMES // CTX_RANKS} frames a rank; rank 0 alone "
        f"evaluated and wrote {saved}; a step {first[0]['step_ms']:.1f} / "
        f"{first[1]['step_ms']:.1f} ms by the host clock, {first[0]['device_step_ms']:.1f} / "
        f"{first[1]['device_step_ms']:.1f} by CUDA events on ranks 0 / 1; peak "
        f"{first[0]['peak_bytes'] / 2**30:.3f} / {first[1]['peak_bytes'] / 2**30:.3f} GiB; "
        f"launches {first[0]['launches']} / {first[1]['launches']}")
    with open(digest) as f:
        expect = [json.load(f)]
    dp_zero_counts()
    plain, probe, _ = run_job(CTX_JOB + ["--ckpt_dir", os.path.join(tmp, "ckpt"), "--run_name",
                                         "ctx"] + CTX_JOB_RESUME,
                              f"{what}: resumed in one plain process", expect)
    one_launches = dp_counts()
    if plain.mesh.group is not None or plain.mesh.n_context != 1 \
            or [(s, same) for s, same, _ in probe.restores] != [(3, True)] \
            or len(probe.steps) != 1:
        raise AssertionError(f"{what}: the one-process resume restored {probe.restores}, "
                             f"{len(probe.steps)} steps")
    log(f"{what}: the step-3 save restored in one plain process bitwise the live state the "
        f"ranks ended with ({probe.restores[0][2]} tensors, digests); it trained step 4 on "
        f"whole clips in {probe.steps[0][1]:.1f} ms by CUDA events")
    del plain, probe
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)
    launches: dict[str, int] = {}
    for counted in (*[r["launches"] for r in first], one_launches):
        _add_launches(launches, counted)
    return {"first": first, "launches": launches}


def phase_context_job_2d(tmp: str, ctx_steps: dict) -> dict:
    """Phase 51: phase 26's flagship job (``TRAIN_JOB``: 512 px synthetic
    images area-resized to 256 on each rank's rows, bf16, hinge + LeCam) at
    ``data=1,context=2`` (``CTX2D_JOB_FIRST``), run by phases 45-50's ranks
    after phase 48's job, sharing the card over gloo, each holding 256 of
    every image's 512 rows: 3 steps, rank 0 alone evaluating (whole images,
    no group) after step 1, logging and saving after step 1 and at the end;
    every rank's GroupNorms all in the two-pass form (``JOB_GN`` of each of
    the four launches a step), no one-launch backward, and no one-launch
    forward but rank 0's eval's. Then one plain process resumes the step-3
    save at ``data=1``, bitwise the live state the ranks ended with (its
    ``state_digest``), and trains step 4 on whole images. Returns the
    reports and launches."""
    import shutil

    first = [r["jobs"][1] for r in ctx_steps["ranks"]]
    what = f"context 2d job ({CTX_RANKS} ranks, {CTX_MESH})"
    seen = [(r["backend"], r["local_batch"], r["mesh"]) for r in first]
    if seen != [("gloo", DP_BATCH, CTX_MESH)] * CTX_RANKS:
        raise AssertionError(f"{what}: (backend, local batch, mesh) {seen}")
    if [r["is_master"] for r in first] != [True, False] \
            or [len(r["evals"]) for r in first] != [1, 0]:
        raise AssertionError(f"{what}: rank 0 alone evaluates "
                             f"{[(r['is_master'], len(r['evals'])) for r in first]}")
    keys = ("gn_ctx_sums", "gn_ctx_apply", "gn_ctx_bwd_sums", "gn_ctx_dx")
    for r in first:
        per = r["launches"]
        if sum(row[-1] for row in r["gn_shapes"]) != JOB_GN \
                or r["gn_shapes"] != first[0]["gn_shapes"]:
            raise AssertionError(f"{what}: rank {r['rank']}'s GroupNorm shapes a step "
                                 f"{r['gn_shapes']}")
        if len(r["steps"]) != 3 or any(per[k] != 3 * JOB_GN for k in keys) \
                or per["gn_bwd"] != 0 or per["gn"] != (JOB_GN if r["rank"] == 0 else 0):
            raise AssertionError(f"{what}: rank {r['rank']}: {len(r['steps'])} steps, "
                                 f"launches {per}")
    run_dir = os.path.join(tmp, "ckpt", "ctx2d")
    check_job_log(job_lines(run_dir, "ctx2d"), range(0, 3), [1], what)
    saved = sorted(os.listdir(os.path.join(run_dir, "state")))
    if saved != ["step_00000001.pt", "step_00000003.pt"]:
        raise AssertionError(f"{what}: saved {saved}")
    log(f"{what}: {first[0]['seconds']:.1f} s; ranks on {[r['device'] for r in first]} over "
        f"gloo, {DP_BATCH} images of 256 of 512 rows a rank; rank 0 alone evaluated and wrote "
        f"{saved}; a step {first[0]['step_ms']:.1f} / {first[1]['step_ms']:.1f} ms by the host "
        f"clock, {first[0]['device_step_ms']:.1f} / {first[1]['device_step_ms']:.1f} by CUDA "
        f"events on ranks 0 / 1; peak {first[0]['peak_bytes'] / 2**30:.3f} / "
        f"{first[1]['peak_bytes'] / 2**30:.3f} GiB; launches {first[0]['launches']} / "
        f"{first[1]['launches']}")
    with open(os.path.join(tmp, "digest_ctx2d.json")) as f:
        expect = [json.load(f)]
    dp_zero_counts()
    plain, probe, _ = run_job(TRAIN_JOB + ["--ckpt_dir", os.path.join(tmp, "ckpt"), "--run_name",
                                           "ctx2d"] + CTX2D_JOB_RESUME,
                              f"{what}: resumed in one plain process", expect)
    one_launches = dp_counts()
    if plain.mesh.group is not None or plain.mesh.n_context != 1 \
            or [(s, same) for s, same, _ in probe.restores] != [(3, True)] \
            or len(probe.steps) != 1:
        raise AssertionError(f"{what}: the one-process resume restored {probe.restores}, "
                             f"{len(probe.steps)} steps")
    log(f"{what}: the step-3 save restored in one plain process bitwise the live state the "
        f"ranks ended with ({probe.restores[0][2]} tensors, digests); it trained step 4 on "
        f"whole images in {probe.steps[0][1]:.1f} ms by CUDA events")
    del plain, probe
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(run_dir)
    launches: dict[str, int] = {}
    for counted in (*[r["launches"] for r in first], one_launches):
        _add_launches(launches, counted)
    return {"first": first, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs "
              "a CUDA device", file=sys.stderr)
        return 1
    # a rank of phases 38-40 or 41, launched by this script through torchrun
    if len(sys.argv) > 2 and sys.argv[1] == "--dp-ranks":
        return dp_ranks_main(sys.argv[2])
    if len(sys.argv) > 2 and sys.argv[1] == "--dp-jobs":
        return dp_jobs_main(sys.argv[2])
    # a rank of phases 45-47
    if len(sys.argv) > 2 and sys.argv[1] == "--ctx-ranks":
        return ctx_ranks_main(sys.argv[2])
    t_smoke = time.perf_counter()

    from vqgan_tpu_torch.ops import attention_cuda as ac
    from vqgan_tpu_torch.ops import conv3d_cuda as cc
    from vqgan_tpu_torch.ops import cuda_build
    from vqgan_tpu_torch.ops import geometry_probe_cuda as gpc
    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.ops import vq_cuda as vq
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32, group_norm_fp32_backward

    # 1. environment
    smi = _card()
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

    # 28. the 3D GAN job through the train3d CLI at TVAEConfig()'s width, and
    # its resume; 29. the 3D recon-only VQ job with attention on clip shards;
    # 30. the native image decoder
    t28 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job3d = phase_train3d_job(gn, cc, tmp)
        t29 = time.perf_counter()
        job3d_vq = phase_train3d_job_vq(gn, cc, vq, ac, tmp)
        t30 = time.perf_counter()
        native_dec = phase_native_decoder(tmp)
    t_end = time.perf_counter()
    log(f"phases 28-30 (the 3D training job, the native decoder): {t_end - t28:.1f} s (28: "
        f"{t29 - t28:.1f} s, 29: {t30 - t29:.1f} s, 30: {t_end - t30:.1f} s) of the "
        f"{t_end - t_smoke:.1f} s the smoke has run so far")

    # 31. the HDR recipe's job through the CLI at its own flags, its .pt
    # served, its resume; 32. remat off/full/conv at its microbatch, and
    # --grad_accum 2 --remat true; 33. the 3D GAN VQ job with accumulation
    # and remat; 34. the microbatched HDR step, CPU vs card
    t31 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        hdr = phase_hdr_job(gn, cc, tmp)
        check_large_upsample()
        t32 = time.perf_counter()
        hdr_remat = phase_hdr_remat(gn, cc, tmp)
        t33 = time.perf_counter()
        job3d_accum = phase_train3d_accum_job(gn, cc, vq, tmp)
    t34 = time.perf_counter()
    phase_hdr_cross_device()
    t_end = time.perf_counter()
    log(f"phases 31-34 (the HDR job, remat and accumulation, the 3D accumulated job, the "
        f"microbatched step across devices): {t_end - t31:.1f} s (31: {t32 - t31:.1f} s, 32: "
        f"{t33 - t32:.1f} s, 33: {t34 - t33:.1f} s, 34: {t_end - t34:.1f} s) of the "
        f"{t_end - t_smoke:.1f} s the smoke has run so far")
    jobs = (job3d, job3d_vq, hdr, hdr_remat, job3d_accum)
    job_launches: dict[str, int] = {}
    for job_run in jobs:
        _add_launches(job_launches, job_run["launches"])
    # kernels #1, #2 and #6 at the jobs' own shapes (#3, #4 and #5: the "3D
    # job" cases of phases 9 and 13)
    job3d_err = kernels_at_job_shapes(gn, cc, [w for j in jobs for w in j["watches"]],
                                      step3d_gn, conv_fwd)
    t_end = time.perf_counter()
    log(f"the jobs' kernels against plain at their shapes: done at {t_end - t_smoke:.1f} s")

    # 35. the flagship 2D serving artifacts; 36. the TVAE artifact; 37. the
    # artifacts between the card and the CPU
    t35 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        export2d = phase_export_2d(gn, ac, vq, tmp)
        t36 = time.perf_counter()
        export3d = phase_export_tvae(gn, cc, ac, vq, tmp)
        t37 = time.perf_counter()
        port_launches = phase_export_portability(gn, ac, vq, tmp)
    t_end = time.perf_counter()
    log(f"phases 35-37 (the serving artifacts): {t_end - t35:.1f} s (35: {t36 - t35:.1f} s, "
        f"36: {t37 - t36:.1f} s, 37: {t_end - t37:.1f} s) of the {t_end - t_smoke:.1f} s the "
        f"smoke has run so far")
    export_launches: dict[str, int] = {}
    for counted in (*export2d["launches"].values(), export3d["launches"], port_launches):
        _add_launches(export_launches, counted)

    # 38. the flagship step at two ranks against one; 39. its VQ variant; 40.
    # the 3D GAN step at TVAEConfig()'s width; 41. the flagship job under
    # torchrun: two ranks, a resume, one rank over NCCL against one process
    # 42. the cases of 38-40 and the flagship step at grad_accum 2 with the
    # train state sharded over fsdp (run by 38-40's ranks); 43. the flagship
    # job at data=1,fsdp=2 (in 41's launch), resumed at data=2 and in one
    # process; 44. the three tools
    t38 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dp_steps = phase_data_parallel_steps(tmp)
        fsdp_steps = phase_fsdp_steps(dp_steps)
        t41 = time.perf_counter()
        dp_jobs_out = phase_data_parallel_jobs(tmp)
        t44 = time.perf_counter()
        tools = phase_tools(tmp, dp_jobs_out["weights"])
    t_end = time.perf_counter()
    log(f"phases 38-44 (data parallelism, fsdp, the tools): {t_end - t38:.1f} s (38-40 and "
        f"42: {t41 - t38:.1f} s, 41 and 43: {t44 - t41:.1f} s, 44: {t_end - t44:.1f} s) of the "
        f"{t_end - t_smoke:.1f} s the smoke has run so far")
    dp_launches: dict[str, int] = {}
    for counted in (dp_steps["launches"], fsdp_steps["launches"], dp_jobs_out["launches"]):
        _add_launches(dp_launches, counted)
    tool_launches = tools["launches"]

    # 45. ring attention on kernel #3 over two context ranks; 46. kernels #1 and
    # #2 in their two-pass form at the 3D step's GroupNorms cut in T; 47. the 3D
    # GAN step, frame and tubelet D, at data=1,context=2 against one rank; 49.
    # halo, and #1 and #2 two-pass at the 2D step's GroupNorms cut in H; 50.
    # the flagship 2D GAN step, with and without attention, at
    # data=1,context=2 against one rank (45-47, 49-50: one torchrun launch,
    # whose ranks then run 48 and 51); 48. phase 28's job at data=1,context=2,
    # its save resumed in one plain process; 51. phase 26's job the same way
    t45 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx_steps = phase_context_steps(tmp)
        t48 = time.perf_counter()
        ctx_job = phase_context_job(tmp, ctx_steps)
        t51 = time.perf_counter()
        ctx_job2d = phase_context_job_2d(tmp, ctx_steps)
    t_end = time.perf_counter()
    log(f"phases 45-51 (the context axis): {t_end - t45:.1f} s (the launch of 45-51 and the "
        f"one-rank runs: {t48 - t45:.1f} s, 48's checks and its one-process resume: "
        f"{t51 - t48:.1f} s, 51's: {t_end - t51:.1f} s) of the {t_end - t_smoke:.1f} s the "
        f"smoke has run so far")
    ctx_launches: dict[str, int] = {}
    for counted in (ctx_steps["launches"], ctx_job["launches"], ctx_job2d["launches"]):
        _add_launches(ctx_launches, counted)
    ring, gn_ctx_job, gn_ctx_2d = (ctx_steps["ring"], ctx_steps["gn"]["job"],
                                   ctx_steps["gn"]["step2d"])
    gn_ctx = {k_: (max(v_[0], gn_ctx_job[k_][0], gn_ctx_2d[k_][0]), *v_[1:])
              for k_, v_ in ctx_steps["gn"]["step"].items()}

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
    log(f"train3d job (CLI, TVAEConfig() width, 16f/128px, batch 2, gaussian, hinge GAN + "
        f"LeCam, Polyak EMA): {job3d['step_ms']:.1f} ms per step by the host clock, "
        f"{job3d['device_step_ms']:.1f} ms between CUDA events, {job3d['wall_ms']:.1f} ms of "
        f"wall time a step ({job3d['wait_ms']:.1f} waiting for the batch), resumed "
        f"{job3d['resume_step_ms']:.1f} ms; eval {', '.join(f'{t:.2f}' for t in job3d['eval_s'])}"
        f" s; save {', '.join(f'{t:.2f}' for t in job3d['save_s'])} s; peak "
        f"{job3d['peak_bytes'] / 2**30:.3f} GiB; whole 6-step call {job3d['seconds']:.1f} s; "
        f"vq job on clip shards (attn_chunk 256) {job3d_vq['step_ms']:.1f} ms per step "
        f"({job3d_vq['device_step_ms']:.1f} by events, {job3d_vq['wall_ms']:.1f} of wall time, "
        f"{job3d_vq['wait_ms']:.1f} waiting for the batch), peak "
        f"{job3d_vq['peak_bytes'] / 2**30:.3f} GiB; native decoder "
        f"{'built' if native_dec['built'] else 'not built'}, the train transform at 512 px: "
        + "; ".join(f"{name} {label} {r:.1f} images/s"
                    for (name, label), r in native_dec["rates"].items()))
    log(f"geometry probe: {probe_counted} launches in the entry point's run; per case "
        f"(kernel, plain, torch.matmul, bound) ms, device time: " + "; ".join(
            f"{c} {v[1]:.4f}/{v[2]:.4f}/{v[3]:.4f}/{v[4]:.5f}" for c, v in probe.items()))
    r = hdr_remat
    log(f"hdr job (CLI, tools/launch_hdr.sh's flags: ch 128, ch_mult 1,2,4,4,4, z 64, wavelet "
        f"+ HR, batch 32 = 4 x 8, 512 px images, hinge + LeCam, clamp, flip and crop): "
        f"{hdr['step_ms']:.1f} ms per step by the host clock, {hdr['device_step_ms']:.1f} ms "
        f"between CUDA events, {hdr['wall_ms']:.1f} ms of the job's wall time "
        f"({hdr['load_ms']:.1f} waiting for the batch), resumed {hdr['resume_step_ms']:.1f} ms; "
        f"eval {', '.join(f'{t:.2f}' for t in hdr['eval_s'])} s; save "
        f"{', '.join(f'{t:.2f}' for t in hdr['save_s'])} s; peak "
        f"{hdr['peak_bytes'] / 2**30:.3f} GiB; whole 4-step call {hdr['seconds']:.1f} s")
    log(f"hdr step at microbatch {HDR_MICROBATCH}: remat off {r['off']['device_step_ms']:.1f} "
        f"ms, peak {r['off']['peak_bytes'] / 2**30:.3f} GiB; full "
        f"{r['full']['device_step_ms']:.1f} ms, {r['full']['peak_bytes'] / 2**30:.3f} GiB; conv "
        f"{r['conv']['device_step_ms']:.1f} ms, {r['conv']['peak_bytes'] / 2**30:.3f} GiB "
        f"(CUDA events); hdr job --grad_accum 2 --remat true (microbatch 16): "
        f"{r['accum2']['step_ms']:.1f} ms per step by the host clock, "
        f"{r['accum2']['device_step_ms']:.1f} by events, peak "
        f"{r['accum2']['peak_bytes'] / 2**30:.3f} GiB")
    log(f"train3d job accum 2 remat (TVAEConfig() width, 16f/128px, batch 2 = 2 x 1, VQ, "
        f"frame D): {job3d_accum['step_ms']:.1f} ms per step by the host clock, "
        f"{job3d_accum['device_step_ms']:.1f} ms between CUDA events, resumed "
        f"{job3d_accum['resume_step_ms']:.1f} ms; peak {job3d_accum['peak_bytes'] / 2**30:.3f} "
        f"GiB")
    for name, key, unit, items in (("identity", "identity", "img", SERVE_BATCH),
                                   ("vq + attention", "vq_attn", "img", SERVE_BATCH)):
        for side, t in export2d[key].items():
            log(_timing_line(f"served artifact (phase 35) 2D {name} batch {items}: {side}", t,
                             unit, items))
    for side, t in export3d["timing"].items():
        log(_timing_line(f"served artifact (phase 36) TVAE 16f/128px batch {CLIP_BATCH}: "
                         f"{side}", t, "frames", CLIP_BATCH * CLIP_FRAMES))
    dp_timing_lines(smi, dp_steps, dp_jobs_out)
    fsdp_timing_lines(smi, fsdp_steps)
    log(f"export seconds: the CLI in a subprocess (flagship identity) {export2d['cli_s']:.1f}, "
        f"export_vae (flagship vq + attention) {export2d['export_s']:.1f}, export_tvae "
        f"(16f/128px) {export3d['export_s']:.1f}; artifacts vs pipelines max_abs_err "
        f"{max(export2d['err'], export3d['err']):.3e}")
    log(f"kernels line: launches on the main paths, each path's counts set to 0 just before "
        f"it and read just after: the earlier paths' below, plus the training jobs' "
        f"(phases 28-29 and 31-33: {job_launches}), the served artifacts' reconstructs "
        f"(phases 35-37: {export_launches}) and the data-parallel ranks' steps and jobs, every "
        f"rank's (phases 38-43: {dp_launches}), the tools' (phase 44: {tool_launches}), the "
        f"context ranks' steps and jobs and the jobs' resumes (phases 47-48 and 50-51: "
        f"{ctx_launches}); "
        f"GroupNorm launches per identity training step and "
        f"ms per step at "
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
        f"times from CUDA graph replays; the two-pass GroupNorm entries (phase 46): launches "
        f"on phases 47-48 and 50-51's paths, max_abs_err over the three paths' shapes "
        f"(phase 47's fp32, phase 48's and phase 50's bf16), ms summed over the calls of a "
        f"context rank's step of phase 47 (fp32; phase 48's and phase 50's bf16 steps in the "
        f"lines above), library "
        f"F.group_norm's whole forward (apply) or backward (dx), none for the sums; the ring "
        f"entries (phase 45): launches of kernel #3 that the ring made on "
        f"phases 47-48 and 50-51's paths, max_abs_err over phase 45's cases against one rank "
        f"over the "
        f"whole sequence, ms of one call of the ring's launch (fp32 outputs) at its block "
        f"({RING_FWD_CASE} forward, {RING_BWD_CASE} backward) with its plain version, SDPA "
        f"and bound")
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
              train_counts["gn"] + job_launches["gn"] + export_launches["gn"]
              + dp_launches["gn"] + tool_launches["gn"] + ctx_launches["gn"],
              max([v[0] for res in fwd.values() for v in res.values()]
                                      + [clip_serve["gn_err"], long_clip["gn_err"], fwd3d_err,
                                         job3d_err["gn"]]),
              fwd_step, "bytes"),
        entry("fused_group_norm_bwd", "groupnorm.cu", "vqgan_tpu/ops/pallas/groupnorm.py:194",
              train_counts["gn_bwd"] + job_launches["gn_bwd"] + dp_launches["gn_bwd"]
              + ctx_launches["gn_bwd"],
              max([v[0] for v in bwd.values()] + [bwd3d_err, job3d_err["gn_bwd"]]), bwd_step,
              "bytes"),
        entry("nearest_codes", "vq.cu", "vqgan_tpu/ops/pallas/vq.py:113",
              vq_counts["nearest"] + job_launches["nearest"] + export_launches["nearest"]
              + dp_launches["nearest"],
              max(v[0] for v in vq_nearest.values()), vq_nearest["flagship b8"][1:],
              "operations"),
        entry("code_stats", "vq.cu", "vqgan_tpu/ops/pallas/vq.py:223",
              vq_counts["stats"] + job_launches["stats"] + dp_launches["stats"],
              max(v[0] for v in vq_stats.values()), vq_stats[("flagship b8", True)][1:],
              "bytes"),
        entry("flash_attention", "attention.cu", "vqgan_tpu/ops/flash_attention.py:90",
              attn_counts["attn"] + job_launches["attn"] + export_launches["attn"]
              + dp_launches["attn"] + ctx_launches["attn"] - ctx_launches["ring"],
              max(v[0] for key, v in attn.items() if key[2] == "fwd"),
              attn_step["fwd"], "operations"),
        entry("flash_attention_bwd", "attention.cu", "vqgan_tpu/ops/flash_attention.py:90",
              attn_counts["attn_bwd"] + job_launches["attn_bwd"] + dp_launches["attn_bwd"]
              + ctx_launches["attn_bwd"] - ctx_launches["ring_bwd"],
              max(v[0] for key, v in attn.items() if key[2] == "bwd"),
              attn_step["bwd"], "operations"),
        entry("conv3d_ttap", "conv3d.cu", "vqgan_tpu/ops/pallas/conv3d.py:243",
              clip_counts["conv3d"] + job_launches["conv3d"] + dp_launches["conv3d"]
              + ctx_launches["conv3d"],
              max([v[0] for v in conv_fwd.values()] + [job3d_err["conv3d"]]), conv_step,
              "operations"),
        entry("conv3d_ttap_dx", "conv3d.cu", "vqgan_tpu/ops/pallas/conv3d.py:316",
              clip_grad["conv3d_dx"] + job_launches["conv3d_dx"] + dp_launches["conv3d_dx"]
              + ctx_launches["conv3d_dx"],
              max([v[0] for v in conv_dx.values()] + [job3d_err["conv3d"]]), dx_step,
              "operations"),
        entry("group_norm_partial_sums", "groupnorm.cu",
              "vqgan_tpu/ops/pallas/groupnorm.py:112", ctx_launches["gn_ctx_sums"],
              gn_ctx["sums"][0], gn_ctx["sums"][1:], "bytes"),
        entry("group_norm_apply", "groupnorm.cu", "vqgan_tpu/ops/pallas/groupnorm.py:131",
              ctx_launches["gn_ctx_apply"], gn_ctx["apply"][0], gn_ctx["apply"][1:], "bytes"),
        entry("group_norm_backward_partial", "groupnorm.cu",
              "vqgan_tpu/ops/pallas/groupnorm.py:218", ctx_launches["gn_ctx_bwd_sums"],
              gn_ctx["bwd_sums"][0], gn_ctx["bwd_sums"][1:], "bytes"),
        entry("group_norm_backward_dx", "groupnorm.cu", "vqgan_tpu/ops/pallas/groupnorm.py:244",
              ctx_launches["gn_ctx_dx"], gn_ctx["dx"][0], gn_ctx["dx"][1:], "bytes"),
        entry("flash_attention_ring", "attention.cu", "vqgan_tpu/ops/flash_attention.py:90",
              ctx_launches["ring"], max(r["errs"]["out"] for r in ring.values()),
              ring[RING_FWD_CASE]["times"]["fwd"], "operations"),
        entry("flash_attention_ring_bwd", "attention.cu", "vqgan_tpu/ops/flash_attention.py:90",
              ctx_launches["ring_bwd"],
              max(r["errs"][k] for r in ring.values() for k in ("dq", "dk", "dv")),
              ring[RING_BWD_CASE]["times"]["bwd"], "operations"),
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
