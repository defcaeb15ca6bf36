"""Time kernel #6's bf16 tensor-core route at every path shape under each
candidate tile and split of K, and hold ``ops/conv3d_cuda.py::tc_rule``'s
pick against the fastest candidate.

    python -m vqgan_tpu_torch.tools.sweep_conv3d [--iters 10] [--out sweep.json]

The path shapes are the forward and the dx (Ci and Co swapped) of every
stride-1 3x3x3 conv of a 16-frame 128 px TVAE reconstruct at batch 2
(``TVAEConfig()``), of the 48-frame 256 px long clip at batch 1 (ch_mult
1,2,4) and of the 3D training config (``tools/profile_step.py``'s
``build_step3d``: ch 64, ch_mult 1,2,4, 1 res block, z 8) at batch 2. The
candidates are the tiles whose width fits Co (``TC_TILES``) and, where a
tile's blocks number fewer than four an SM, the splits of ``TC_SPLITS``
that leave at least 4 steps of K. Each candidate's output is held against
the plain version (``ops/conv3d.py::bound_share`` <= 1); its device time
(the weight's packing, the conv and the reduce of the splits; ``device_ms``)
is taken twice, in two passes over the candidates, and the lesser counts.
Prints one line per shape: every candidate's ms, the fastest, the rule's
pick and how much slower it is than the fastest, beside the run-to-run
spread (the median over the candidates of how far the two passes lie
apart); then the shapes where the rule loses by more than that spread.
``--out`` writes every timing as JSON. Needs a CUDA device; fails without
one. Exits 1 if a candidate disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

import torch

from vqgan_tpu_torch.ops import conv3d_cuda as cc
from vqgan_tpu_torch.ops.conv3d import bound_share, conv3d_plain
from vqgan_tpu_torch.ops.cuda_build import num_sms

# (Ci, Co, T, H, W) of the forward convs, by config; (batch, shapes)
CLIP_16F = (2, {(3, 64, 16, 128, 128), (64, 64, 16, 128, 128), (64, 128, 8, 64, 64),
                (128, 128, 8, 64, 64), (128, 256, 4, 32, 32), (256, 256, 4, 32, 32),
                (256, 256, 2, 16, 16), (256, 32, 2, 16, 16), (16, 256, 2, 16, 16),
                (256, 256, 8, 64, 64), (256, 128, 8, 64, 64), (128, 128, 16, 128, 128),
                (128, 64, 16, 128, 128), (64, 3, 16, 128, 128)})
CLIP_48F = (1, {(3, 64, 48, 256, 256), (64, 64, 48, 256, 256), (64, 128, 24, 128, 128),
                (128, 128, 24, 128, 128), (128, 256, 12, 64, 64), (256, 256, 12, 64, 64),
                (256, 32, 12, 64, 64), (16, 256, 12, 64, 64), (256, 256, 24, 128, 128),
                (256, 128, 24, 128, 128), (128, 128, 48, 256, 256), (128, 64, 48, 256, 256),
                (64, 3, 48, 256, 256)})
STEP3D = (2, {(3, 64, 16, 128, 128), (64, 64, 16, 128, 128), (64, 128, 8, 64, 64),
              (128, 128, 8, 64, 64), (128, 256, 4, 32, 32), (256, 256, 4, 32, 32),
              (256, 16, 4, 32, 32), (8, 256, 4, 32, 32), (256, 256, 8, 64, 64),
              (256, 128, 8, 64, 64), (128, 128, 16, 128, 128), (128, 64, 16, 128, 128),
              (64, 3, 16, 128, 128)})


def path_shapes() -> list[tuple[int, int, int, int, int, int]]:
    """(B, Ci, Co, T, H, W) of every forward and dx call, once each."""
    out = set()
    for batch, shapes in (CLIP_16F, CLIP_48F, STEP3D):
        for ci, co, t, h, w in shapes:
            out.add((batch, ci, co, t, h, w))
            out.add((batch, co, ci, t, h, w))
    return sorted(out, key=lambda s: (s[0] * s[3] * s[4] * s[5], s[1], s[2]))


def candidates(m: int, ci: int, co: int, sms: int) -> list[cc.LaunchPlan]:
    """Every tile of width min(Co, 64) to 2·Co (at least 16), each at one
    split and, where its blocks number fewer than four an SM, at the splits
    of ``TC_SPLITS`` that leave at least 4 steps."""
    n_chunks = math.ceil(27 * ci / cc.BLOCK_K["tc"])
    plans = []
    for tile, (bm, bn) in enumerate(cc.TC_TILES):
        if not min(co, 64) <= bn <= max(2 * co, 16):
            continue
        n_pad = math.ceil(co / bn) * bn
        tiles = math.ceil(m / bm) * (n_pad // bn)
        for s in cc.TC_SPLITS:
            if s > 1 and (tiles >= 4 * sms or s > n_chunks // 4):
                break
            splits, per = cc._split(n_chunks, s)
            plans.append(cc.LaunchPlan("tc", tile, bm, bn, n_pad, n_chunks, splits, per))
    return plans


def device_ms(fn, iters: int, repeats: int = 3) -> float:
    """The device's time of one call of ``fn``: ``iters`` calls captured in
    one CUDA graph (after two calls that build, allocate and warm up), the
    least of ``repeats`` replays over ``iters``. A graph launches its
    kernels with no host work between them, so a call whose kernels take
    less time than the host takes to launch them is timed by the kernels."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(repeats):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_conv3d: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = num_sms(dev.index or 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs", flush=True)
    records, losses, bad = [], [], 0
    for b, ci, co, t, h, w in path_shapes():
        m = b * t * h * w
        x = torch.randn((b, t, h, w, ci), generator=gen, device=dev).bfloat16()
        x = x.permute(0, 4, 1, 2, 3)
        wt = (torch.randn((co, ci, 3, 3, 3), generator=gen, device=dev)
              / (27 * ci) ** 0.5).bfloat16()
        ref = conv3d_plain(x, wt)
        iters = max(2, args.iters // 4) if m * ci * co > 2 ** 34 else args.iters
        plans = candidates(m, ci, co, sms)
        rule = cc.launch_plan(m, ci, co, sms, torch.bfloat16)
        if all((p.tile, p.splits) != (rule.tile, rule.splits) for p in plans):
            plans.append(rule)
        for plan in plans:
            used = bound_share(cc._launch(x, wt, plan), ref, x, wt)
            if used > 1.0:
                bad += 1
                print(f"WRONG: {(b, ci, co, t, h, w)} tile {plan.tile} splits {plan.splits}: "
                      f"share of the bound used {used:.3f}", flush=True)
        passes = [{(p.tile, p.splits): device_ms(lambda p=p: cc._launch(x, wt, p), iters)
                   for p in plans} for _ in range(2)]
        times = {k: min(a[k] for a in passes) for k in passes[0]}
        spread = statistics.median(abs(passes[0][k] - passes[1][k]) / times[k] for k in times)
        best = min(times, key=times.get)
        pick = (rule.tile, rule.splits)
        loss = times[pick] / times[best] - 1
        if loss > spread:
            losses.append(((b, ci, co, t, h, w), pick, best, loss, spread))
        flop = 2 * 27 * ci * co * m
        records.append({"shape": [b, ci, co, t, h, w], "m": m, "best": list(best),
                        "best_ms": times[best], "rule": list(pick), "rule_ms": times[pick],
                        "spread": spread,
                        "times": [[k[0], k[1], passes[0][k], passes[1][k]]
                                  for k in sorted(times)]})
        print(f"B={b} Ci={ci} Co={co} T={t} H={h} W={w}: fastest tile {best[0]} x {best[1]} "
              f"splits {times[best]:.4f} ms ({flop / times[best] / 1e9:.1f} TFLOP/s); rule "
              f"tile {pick[0]} x {pick[1]} {times[pick]:.4f} ms, {loss:+.3f} (spread "
              f"{spread:.3f}); all " + " ".join(f"{k[0]}x{k[1]}={v:.4f}"
                                                 for k, v in sorted(times.items())), flush=True)
        del x, wt, ref
        torch.cuda.empty_cache()
    print(f"tc_rule slower than the fastest candidate by more than the spread at "
          f"{len(losses)} of {len(records)} shapes"
          + "".join(f"; {s}: rule {p}, fastest {q}, {d:+.3f} (spread {e:.3f})"
                    for s, p, q, d, e in losses))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0), "records": records}, f)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
