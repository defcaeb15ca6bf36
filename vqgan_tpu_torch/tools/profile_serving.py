"""Where the device time of the serving path goes, from a torch.profiler trace.

    python -m vqgan_tpu_torch.tools.profile_serving [--batch 8] [--out DIR]
        [--use_attn] [--attn_chunk 512]
    python -m vqgan_tpu_torch.tools.profile_serving --clips [--batch 2]
        [--frames 16] [--res 128] [--ch_mult 1,2,4,4] [--attn_chunk 0]

Builds the flagship pipeline (``VAEConfig()`` defaults, with the mid-block
AttnBlocks under ``--use_attn``; random weights from a seed) on the first
CUDA device, or with ``--clips`` the TVAE clip pipeline (``TVAEConfig()``
with the given ch_mult and attn_chunk, clips of ``--frames`` x ``--res`` px),
runs one warm-up reconstruct, then profiles ``--iters`` reconstructs. Prints
the device time by kernel class (GroupNorm kernel, Conv3d kernel, attention
kernel, convolutions, other), the top kernels by device time, the attention
kernels' time per reconstruct, and the device's busy share of the profiled
window (union of kernel intervals over the window's host-clock length). In
the 2D mode it then profiles the GroupNorm kernel alone at the flagship
shapes and prints the time of each of its three launches. Writes the chrome
trace of the reconstructs to ``DIR/serving_trace.json`` when ``--out`` is
given. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

GN_PREFIX = "gn_"
GN_BWD_PREFIX = "gn_bwd_"
VQ_PREFIX = "vq_"
ATTN_FWD_PREFIX = "attn_fwd"
ATTN_BWD_PREFIX = "attn_bwd"
CONV3D_PREFIX = "conv3d_"
CONV_MARKERS = ("conv", "xmma", "gemm", "cudnn", "implicit", "wgrad", "dgrad",
                "nchwToNhwc", "nhwcToNchw")


def kernel_class(name: str) -> str:
    # the GroupNorm, VQ and attention kernels live in an anonymous namespace:
    # "void (anonymous namespace)::gn_stats_kernel<float>(...)"; the
    # parameter list may name the namespace's types too
    found = re.search(r"::(\w+)", name)
    base = found.group(1) if found else name
    if base.startswith(ATTN_FWD_PREFIX):
        return "attention kernel, forward"
    if base.startswith(ATTN_BWD_PREFIX):
        return "attention kernels, backward (delta, dK/dV, dQ)"
    if base.startswith(CONV3D_PREFIX):
        return "conv3d kernel (#6; with its split-K reduce)"
    if base.startswith(VQ_PREFIX):
        return "VQ kernels (nearest-code search, code statistics)"
    if base.startswith(GN_BWD_PREFIX):
        return "groupnorm kernel, backward"
    if base.startswith(GN_PREFIX):
        return "groupnorm kernel, forward"
    low = name.lower()
    if any(m.lower() in low for m in CONV_MARKERS):
        return "conv (cuDNN)"
    return "other"


def device_kernels(prof) -> list:
    """The trace's device kernels and copies; GPU user annotations (such as
    ``Optimizer.step#AdamW.step``) span other kernels and are left out, as
    in torch.profiler's own summaries."""
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    return kernels


def busy_us(kernels) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def print_attention_kernels(ranked: list, per: int, unit: str) -> None:
    """The attention kernels of a profile ranked by device time, ms per
    ``unit`` over ``per`` units."""
    attn = [(name, v) for name, v in ranked if kernel_class(name).startswith("attention")]
    if attn:
        print("attention kernels:")
        for name, (us, n) in attn:
            print(f"  {us / per / 1e3:8.4f} ms/{unit}  {n // per:4d} calls/{unit}  {name[:110]}")


def profile_reconstruct(batch: int, iters: int, out_dir: str | None, use_attn: bool = False,
                        attn_chunk: int = 0) -> None:
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.models.ae import init_vae

    cfg = VAEConfig(use_attn=use_attn, attn_chunk=attn_chunk)
    sd = init_vae(cfg, torch.Generator().manual_seed(0)).state_dict()
    pipe = VAEPipeline(cfg, sd, device="cuda")
    images = np.random.RandomState(0).randint(
        0, 256, (batch, cfg.resolution, cfg.resolution, 3), np.uint8)
    profile_pipeline(pipe, images, iters, out_dir)


def profile_clips(batch: int, frames: int, res: int, ch_mult: tuple, attn_chunk: int,
                  iters: int, out_dir: str | None) -> None:
    from vqgan_tpu_torch.config import TVAEConfig
    from vqgan_tpu_torch.inference import TVAEPipeline
    from vqgan_tpu_torch.models.tae import init_tvae

    cfg = TVAEConfig(resolution=res, ch_mult=ch_mult, attn_chunk=attn_chunk)
    sd = init_tvae(cfg, torch.Generator().manual_seed(0)).state_dict()
    pipe = TVAEPipeline(cfg, sd, device="cuda")
    clips = np.random.RandomState(0).randint(0, 256, (batch, frames, res, res, 3), np.uint8)
    print(f"TVAE clips: batch {batch}, {frames} frames x {res} px, ch_mult {ch_mult}, "
          f"attn_chunk {attn_chunk}")
    profile_pipeline(pipe, clips, iters, out_dir)


def profile_pipeline(pipe, inputs: np.ndarray, iters: int, out_dir: str | None) -> None:
    """One warm-up reconstruct of ``inputs``, then ``iters`` profiled."""
    batch = len(inputs)
    pipe.reconstruct(inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            pipe.reconstruct(inputs)  # ends in a device-to-host copy
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    by_class: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        dur = e.time_range.elapsed_us()
        cls = kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += dur
        entry[1] += 1
    total = sum(by_class.values())
    busy = busy_us(kernels)
    print(f"reconstruct batch {batch}, {iters} iters: window {window_us / iters / 1e3:.3f} "
          f"ms/iter host clock, kernels {total / iters / 1e3:.3f} ms/iter, device busy "
          f"{busy / window_us:.4f} of the window (idle {1 - busy / window_us:.4f})")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {us / iters / 1e3:.3f} ms/iter ({us / total:.4f} of kernel time)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print("top kernels by device time:")
    for name, (us, n) in ranked[:15]:
        print(f"  {us / iters / 1e3:8.3f} ms/iter  {n // iters:4d} calls/iter  {name[:110]}")
    print_attention_kernels(ranked, iters, "iter")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "serving_trace.json"))


def profile_groupnorm(batch: int) -> None:
    from vqgan_tpu_torch.ops.groupnorm_cuda import fused_group_norm

    gen = torch.Generator(device="cuda").manual_seed(0)
    for s, c, dtype in [(1024, 1024, torch.bfloat16), (16384, 256, torch.float32),
                        (65536, 512, torch.bfloat16), (65536, 256, torch.float32)]:
        side = int(round(s ** 0.5))
        x = torch.randn((batch, side, side, c), generator=gen, device="cuda")
        x = x.to(dtype).permute(0, 3, 1, 2)
        w = torch.ones(c, device="cuda")
        b = torch.zeros(c, device="cuda")
        for _ in range(3):
            fused_group_norm(x, w, b, 32, 1e-6, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fused_group_norm(x, w, b, 32, 1e-6, True)
            torch.cuda.synchronize()
        times: dict[str, float] = {}
        for e in device_kernels(prof):
            base = e.name.split("::")[-1].split("<")[0].split("(")[0]
            times[base] = times.get(base, 0.0) + e.time_range.elapsed_us() / 10
        parts = ", ".join(f"{k} {v:.2f} us" for k, v in times.items())
        print(f"gn B={batch} S={s} C={c} {str(dtype).split('.')[-1]} swish: {parts}")


def main() -> None:
    from vqgan_tpu_torch.config import parse_ch_mult

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--out", default=None)
    parser.add_argument("--use_attn", action="store_true")
    parser.add_argument("--attn_chunk", type=int, default=None,
                        help="default 512 for images, 0 for --clips")
    parser.add_argument("--clips", action="store_true", help="profile the TVAE clip pipeline")
    parser.add_argument("--frames", type=int, default=16)
    parser.add_argument("--res", type=int, default=128)
    parser.add_argument("--ch_mult", default="1,2,4,4")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; tf32: cudnn {torch.backends.cudnn.allow_tf32}, "
          f"matmul {torch.backends.cuda.matmul.allow_tf32}")
    if args.clips:
        profile_clips(args.batch, args.frames, args.res, parse_ch_mult(args.ch_mult),
                      args.attn_chunk or 0, args.iters, args.out)
        return
    chunk = 512 if args.attn_chunk is None else args.attn_chunk
    profile_reconstruct(args.batch, args.iters, args.out, args.use_attn, chunk)
    for b in (2, args.batch):
        profile_groupnorm(b)


if __name__ == "__main__":
    main()
