"""Time kernel #2, the GroupNorm backward, or with ``--forward`` kernel #1,
the forward, at every path shape under each candidate plan, and hold
``ops/groupnorm_cuda.py::backward_plan``'s (or ``forward_plan``'s) pick
against the fastest candidate.

    python -m vqgan_tpu_torch.tools.sweep_gn_bwd [--forward] [--iters 10] [--out sweep.json]

The path shapes are the 50 GroupNorm calls of a flagship training step at
batch 8 (eight (S, C) pairs, bf16 and fp32, with the swish) and the 5-D
calls of the 3D training steps at 16 frames x 128 px, batch 2 (bf16, with
and without the swish). The backward's candidates are
``backward_candidates``' plans (slice width, teams) at the teams of
``TEAMS``; the forward's, ``forward_candidates``' (slice width, cluster,
held packs). Each one's output (dx, or y) is held against the plain version
(fp32 within 1e-5, bf16 within one bf16 ulp) and its device time
(``sweep_conv3d.device_ms``: calls replayed from a CUDA graph) is the
lesser of two passes over the candidates. Prints one line per shape: the
rule's pick and its ms, the fastest candidate and its ms, and the rule's
loss against it beside the run-to-run spread. ``--out`` writes every timing
as JSON. Needs a CUDA device; fails without one. Exits 1 if a candidate
disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys

import torch

from vqgan_tpu_torch.ops import groupnorm_cuda as gn
from vqgan_tpu_torch.ops.cuda_build import num_sms
from vqgan_tpu_torch.ops.groupnorm_cuda import HBM_BYTES_PER_S
from vqgan_tpu_torch.ops.normalization import group_norm_fp32_backward, group_norm_fp32_forward
from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

# (S, C) of the flagship step's calls at batch 8, and the 3D steps' 5-D
# (C, T, H, W) at batch 2
FLAGSHIP = [(65536, 256), (65536, 512), (16384, 1024), (16384, 512), (16384, 256),
            (4096, 1024), (4096, 512), (1024, 1024)]
STEP3D = [(64, 16, 128, 128), (128, 16, 128, 128), (128, 8, 64, 64), (256, 8, 64, 64),
          (256, 4, 32, 32)]
TEAMS = (1, 2, 3, 4, 6, 8, 11, 12, 16, 22, 24, 33, 44, 66, 88, 132, 264)


def path_cases() -> list[tuple[tuple[int, ...], torch.dtype, bool]]:
    """(shape, dtype, swish) of every timed call."""
    cases = []
    for s, c in FLAGSHIP:
        side = math.isqrt(s)
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(((8, c, side, side), dtype, True))
    for c, t, h, w in STEP3D:
        for swish in (False, True):
            cases.append(((2, c, t, h, w), torch.bfloat16, swish))
    return cases


def _inputs(shape, dtype, gen):
    b, c = shape[:2]
    x = (torch.randn((b, *shape[2:], c), generator=gen, device="cuda") * 1.5 + 0.3)
    g = torch.randn((b, *shape[2:], c), generator=gen, device="cuda")
    w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.5 * torch.randn(c, generator=gen, device="cuda")
    return x.to(dtype).movedim(-1, 1), g.to(dtype).movedim(-1, 1), w, bias


def forward_cases(shape, dtype, swish) -> tuple:
    """(the rule's plan, every candidate that the card holds) of one forward
    call."""
    b, c = shape[:2]
    s = math.prod(shape[2:])
    size = torch.empty((), dtype=dtype).element_size()
    pick = gn.forward_plan(b, s, c, 32, size)
    cands = [plan for plan in gn.forward_candidates(b, s, c, 32, size)
             if gn.forward_max_clusters(torch.cuda.current_device(), dtype, swish, plan.cluster,
                                        plan.smem_bytes) >= 1]
    return pick, cands if pick in cands else [pick, *cands]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true", help="kernel #1, the forward")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_gn_bwd needs a CUDA device", file=sys.stderr)
        return 1
    sms = num_sms(torch.cuda.current_device())
    if args.forward:
        return sweep_forward(args)
    gen = torch.Generator(device="cuda").manual_seed(0)
    records, wrong, losses, spreads = [], [], [], []
    for shape, dtype, swish in path_cases():
        x, g, w, bias = _inputs(shape, dtype, gen)
        b, c = shape[:2]
        s = math.prod(shape[2:])
        _, stats = gn.group_norm_forward(x, w, bias, 32, 1e-6, swish)
        ref = group_norm_fp32_backward(x, g, stats[:, 0], stats[:, 1], w, bias, 32, swish)[0]
        ref = ref.float()
        tol = 1e-5 if dtype == torch.float32 else 1e-5 + 2.0 ** -7 * ref.abs()
        per_sm = gn.backward_blocks_per_sm(torch.cuda.current_device(), dtype, swish)
        pick = gn.backward_plan(b, s, c, 32, x.element_size(), sms, blocks_per_sm=per_sm)
        cands = [p for p, _ in gn.backward_candidates(b, s, c, 32, x.element_size(), sms,
                                                      blocks_per_sm=per_sm)
                 if p.teams in TEAMS or p == pick]
        times = {}
        for plan in cands:
            dx = gn.group_norm_backward(x, g, stats, w, bias, 32, swish, plan)[0]
            if not bool(((dx.float() - ref).abs() <= tol).all()):
                wrong.append((shape, str(dtype), swish, plan.describe()))
            times[plan] = []
        for _ in range(2):
            for plan in cands:
                times[plan].append(device_ms(
                    lambda: gn.group_norm_backward(x, g, stats, w, bias, 32, swish, plan),
                    args.iters))
        best = min(cands, key=lambda p: min(times[p]))
        t_pick, t_best = min(times[pick]), min(times[best])
        spread = statistics.median(abs(a - b_) / min(a, b_) for a, b_ in times.values())
        losses.append(t_pick / t_best - 1)
        spreads.append(spread)
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"{shape} {name} swish={int(swish)}: rule {pick.describe()} {t_pick:.4f} ms; "
              f"fastest {best.describe()} {t_best:.4f} ms; rule/fastest {t_pick / t_best:.3f} "
              f"(spread {spread:.3f}); {len(cands)} candidates", flush=True)
        records.append({"shape": shape, "dtype": name, "swish": swish,
                        "rule": [pick.width, pick.teams], "times": [
                            {"width": p.width, "teams": p.teams, "team_blocks": p.team_blocks,
                             "ms": times[p]} for p in cands]})
        del x, g, ref
        torch.cuda.empty_cache()
    print(f"rule against the fastest: median loss {statistics.median(losses):.3f}, worst "
          f"{max(losses):.3f}; median run-to-run spread {statistics.median(spreads):.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)
    if wrong:
        print(f"candidates that disagree with the plain version: {wrong}", file=sys.stderr)
        return 1
    return 0


def sweep_forward(args) -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    records, wrong, losses, spreads = [], [], [], []
    for shape, dtype, swish in path_cases():
        x, _, w, bias = _inputs(shape, dtype, gen)
        ref = group_norm_fp32_forward(x, w, bias, 32, 1e-6, swish)[0].float()
        tol = 1e-5 if dtype == torch.float32 else 1e-6 + 2.0 ** -7 * ref.abs()
        pick, cands = forward_cases(shape, dtype, swish)
        times = {}
        for plan in cands:
            y = gn.group_norm_forward(x, w, bias, 32, 1e-6, swish, plan)[0]
            if not bool(((y.float() - ref).abs() <= tol).all()):
                wrong.append((shape, str(dtype), swish, plan.describe()))
            times[plan] = []
        del y
        for _ in range(2):
            for plan in cands:
                times[plan].append(device_ms(
                    lambda: gn.group_norm_forward(x, w, bias, 32, 1e-6, swish, plan),
                    args.iters))
        best = min(cands, key=lambda p: min(times[p]))
        t_pick, t_best = min(times[pick]), min(times[best])
        spread = statistics.median(abs(a - b_) / min(a, b_) for a, b_ in times.values())
        losses.append(t_pick / t_best - 1)
        spreads.append(spread)
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        moved = 2 * x.numel() * x.element_size()
        print(f"fwd {shape} {name} swish={int(swish)}: rule {pick.describe()} {t_pick:.4f} ms "
              f"({moved / HBM_BYTES_PER_S * 1e3 / t_pick:.3f} of the bound); fastest "
              f"{best.describe()} {t_best:.4f} ms; rule/fastest {t_pick / t_best:.3f} (spread "
              f"{spread:.3f}); {len(cands)} candidates", flush=True)
        records.append({"shape": shape, "dtype": name, "swish": swish,
                        "rule": dataclasses.asdict(pick), "times": [
                            dict(dataclasses.asdict(p), ms=times[p]) for p in cands]})
        del x, ref
        torch.cuda.empty_cache()
    print(f"forward rule against the fastest: median loss {statistics.median(losses):.3f}, "
          f"worst {max(losses):.3f}; median run-to-run spread {statistics.median(spreads):.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)
    if wrong:
        print(f"candidates that disagree with the plain version: {wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
