#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vqgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. environment: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the TF32 flags;
  2. build the CUDA GroupNorm kernel from ``vqgan_tpu_torch/csrc/``;
  3. the kernel against its plain PyTorch version at every GroupNorm shape of
     a flagship reconstruct, batch 2 and batch 8 (the serving phase's batch),
     fp32 and bf16, swish on and off: max abs error against the stated
     tolerance, kernel and plain times (CUDA events);
  4. the serving path at the flagship config (``VAEConfig()``: ch=256,
     ch_mult 1,2,4,4, 256 px), random weights from a seed, written as a
     reference-format .pt and served through ``VAEPipeline.from_checkpoint``:
     shapes, finiteness, ranges, exactly 21 kernel launches per encode and 29
     per decode, img/s and peak memory at batch 8;
  5. the same weights and images on the CPU (plain GroupNorm) and on the card
     (kernel) at a reduced width, TF32 off.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints neither.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SERVE_BATCH = 8
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


def phase_kernel_vs_plain(gn, group_norm_fp32, batch: int) -> dict:
    """Returns {(S, C, dtype, swish): (max_abs_err, kernel_ms, plain_ms)}."""
    shapes = sorted(set(ENCODER_GN_SHAPES) | set(DECODER_GN_SHAPES))
    gen = torch.Generator(device="cuda").manual_seed(batch)
    out = {}
    for s, c in shapes:
        side = int(round(s ** 0.5))
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((batch, side, side, c), generator=gen, device="cuda")
            x = (x * 1.5 + 0.3).to(dtype).permute(0, 3, 1, 2)  # channels_last
            w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
            b = 0.5 * torch.randn(c, generator=gen, device="cuda")
            for swish in (False, True):
                got = gn.fused_group_norm(x, w, b, 32, 1e-6, swish)
                ref = group_norm_fp32(x, w, b, 32, 1e-6, swish)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                if dtype == torch.float32:
                    ok = err <= ATOL_FP32
                    tol = f"atol {ATOL_FP32:g}"
                else:
                    ok = bool((diff <= 1e-6 + RTOL_BF16 * ref.float().abs()).all())
                    tol = "1 bf16 ulp (rtol 2^-7)"
                k_ms = cuda_ms(lambda: gn.fused_group_norm(x, w, b, 32, 1e-6, swish))
                p_ms = cuda_ms(lambda: group_norm_fp32(x, w, b, 32, 1e-6, swish))
                name = "bf16" if dtype == torch.bfloat16 else "fp32"
                log(f"gn B={batch} S={s} C={c} {name} swish={int(swish)}: "
                    f"max_abs_err={err:.3e} ({tol}) kernel_ms={k_ms:.4f} "
                    f"plain_ms={p_ms:.4f} {'ok' if ok else 'MISS'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with plain at {(s, c, name, swish)}")
                out[(s, c, dtype, swish)] = (err, k_ms, p_ms)
    return out


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


def phase_cross_device() -> None:
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline

    set_tf32(False)
    base = VAEConfig(resolution=64, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2,
                     z_channels=16)
    images = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3), np.uint8)
    for dec_dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dec_dtype=dec_dtype)
        sd = _perturbed_state_dict(cfg, seed=1)
        cpu = VAEPipeline(cfg, sd, device="cpu")
        gpu = VAEPipeline(cfg, sd, device="cuda")
        z_cpu, z_gpu = cpu.encode(images), gpu.encode(images).cpu()
        z_err = float((z_cpu - z_gpu).abs().max())
        # both decoders get the CPU latents, so the decode is compared alone
        r_cpu, r_gpu = cpu.decode(z_cpu), gpu.decode(z_cpu)
        r_err = np.abs(r_cpu - r_gpu)
        log(f"cross-device ch=64 (1,2,4) 64px, dec {dec_dtype}: latents max_abs_err="
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run needs "
              "a CUDA device", file=sys.stderr)
        return 1

    from vqgan_tpu_torch.ops import cuda_build
    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    set_tf32(False)

    # 2. build
    t0 = time.perf_counter()
    gn.library()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"({cuda_build.library_path('groupnorm').name})")

    # 3. kernel vs plain
    results = {b: phase_kernel_vs_plain(gn, group_norm_fp32, b)
               for b in (2, SERVE_BATCH)}

    # 4. flagship serving path
    with tempfile.TemporaryDirectory() as tmp:
        main_launches, flagship = phase_flagship(gn, tmp)

    # 5. whole path, CPU vs card
    phase_cross_device()

    # the 50 GN calls of one flagship reconstruct (all with swish fused),
    # summed from the per-shape times: [kernel ms, plain ms] per batch
    per_reconstruct = {}
    for b, res in results.items():
        per_reconstruct[b] = [
            sum(n * res[(s, c, torch.float32, True)][i]
                for (s, c), n in ENCODER_GN_SHAPES.items())
            + sum(n * res[(s, c, torch.bfloat16, True)][i]
                  for (s, c), n in DECODER_GN_SHAPES.items())
            for i in (1, 2)
        ]
        log(f"GN per flagship reconstruct at batch {b}: kernel "
            f"{per_reconstruct[b][0]:.4f} ms, plain {per_reconstruct[b][1]:.4f} ms")
    ms, plain_ms = per_reconstruct[SERVE_BATCH]
    log(f"kernel ms / plain_ms below: batch {SERVE_BATCH}, the serving phase's")
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "fused_group_norm",
        "route": "cuda",
        "source": "vqgan_tpu_torch/csrc/groupnorm.cu",
        "replaces": "vqgan_tpu/ops/pallas/groupnorm.py:91",
        "launches": main_launches,
        "max_abs_err": max(v[0] for res in results.values() for v in res.values()),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
