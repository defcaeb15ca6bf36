"""Time kernel #1, the GroupNorm forward, as the wrapper runs it (its own
plan), at every path shape: for comparing two trees in one call on one card
(parent, change, change, parent: run it from each checkout's root in turn;
it needs nothing of the tree but ``ops/groupnorm_cuda.group_norm_forward``
and ``tools/sweep_conv3d.device_ms``).

    python -m vqgan_tpu_torch.tools.time_gn_fwd [--tag NAME] [--iters 20]

The shapes: the flagship training step's GroupNorms at batch 8 (bf16 with
the swish; fp32 too) and the 3D training steps' 5-D calls at 16 frames x 128
px, batch 2 (bf16, with and without the swish). One line a shape: the
kernel's device time (CUDA graph replays), the bound (x read once, y
written once at 3.35 TB/s) and, unless ``--kernel_only``, the plain
version's and ``F.group_norm``'s; then the flagship step's 50 bf16 calls
summed. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12
# (S, C) -> calls of a flagship training step (encoder + decoder, batch 8)
FLAGSHIP_CALLS = {(65536, 256): 10, (16384, 256): 1, (16384, 512): 8, (4096, 512): 1,
                  (4096, 1024): 9, (1024, 1024): 19, (16384, 1024): 1, (65536, 512): 1}
# (C, T, H, W) of the 3D training steps' GroupNorms at batch 2
STEP3D = [(64, 16, 128, 128), (128, 16, 128, 128), (128, 8, 64, 64), (256, 8, 64, 64),
          (256, 4, 32, 32)]


def cases() -> list:
    out = []
    for s, c in FLAGSHIP_CALLS:
        side = math.isqrt(s)
        for dtype in (torch.bfloat16, torch.float32):
            out.append(((8, c, side, side), dtype, True))
    for c, t, h, w in STEP3D:
        for swish in (False, True):
            out.append(((2, c, t, h, w), torch.bfloat16, swish))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernel_only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gn_fwd needs a CUDA device", file=sys.stderr)
        return 1
    from vqgan_tpu_torch.ops import groupnorm_cuda as gn
    from vqgan_tpu_torch.ops.normalization import group_norm_fp32
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    step_ms = step_bound = 0.0
    for shape, dtype, swish in cases():
        b, c = shape[:2]
        x = torch.randn((b, *shape[2:], c), generator=gen, device="cuda") * 1.5 + 0.3
        x = x.to(dtype).movedim(-1, 1)
        w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.5 * torch.randn(c, generator=gen, device="cuda")
        k = device_ms(lambda: gn.group_norm_forward(x, w, bias, 32, 1e-6, swish), args.iters)
        bound = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        line = (f"{args.tag} gn fwd {shape} {str(dtype)[6:]} swish={int(swish)}: kernel {k:.4f} "
                f"ms, bound {bound:.4f} ms ({bound / k:.3f} of it)")
        if not args.kernel_only:
            iters = 3 if x.numel() * 4 > 2**29 else args.iters
            p = device_ms(lambda: group_norm_fp32(x, w, bias, 32, 1e-6, swish), iters)

            def library():
                y = F.group_norm(x, 32, w.to(dtype), bias.to(dtype), 1e-6)
                return F.silu(y) if swish else y

            line += f", plain {p:.4f} ms, F.group_norm {device_ms(library, iters):.4f} ms"
        print(line, flush=True)
        key = (math.prod(shape[2:]), c)
        if dtype == torch.bfloat16 and b == 8:
            step_ms += FLAGSHIP_CALLS[key] * k
            step_bound += FLAGSHIP_CALLS[key] * bound
        del x
        torch.cuda.empty_cache()
    print(f"{args.tag} gn fwd per flagship training step (50 bf16 calls with the swish, batch "
          f"8): kernel {step_ms:.4f} ms, bound {step_bound:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
