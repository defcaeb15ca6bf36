"""Where a unit's time goes in kernel #1, the GroupNorm forward: a phase
clock read from a diagnostic build.

    python -m vqgan_tpu_torch.tools.trace_gn_fwd

Builds ``csrc/groupnorm.cu`` with ``-DGN_FWD_TRACE``, in which thread 0 of
every block stamps the global timer at the phase boundaries of each of its
first 16 units, and runs one forward call at each case below (a few path
shapes, under the rule's plan and some others), after two untimed calls.
Prints, per phase (waiting for the unit's first round; the later rounds
and the sums; the cluster barrier; the fold and the coefficients; y), the mean
over blocks and units and the mean of the slowest block; then the call's
span on the clock and how the blocks' starts spread over it (quartiles),
which shows how the clusters take their units. The stamps cost a
few instructions a unit. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import sys

import torch

from vqgan_tpu_torch.ops import groupnorm_cuda as gn

DEFINES = ("-DGN_FWD_TRACE",)
UNITS, PHASES = 16, 6  # csrc/groupnorm.cu kFwdTraceUnits, kFwdTracePhases
NAMES = ("wait for the first round", "later rounds and sums", "cluster barrier",
         "fold + coefficients", "y")
# (shape, dtype, swish, plan changes from the rule's: None for the rule's own)
CASES = [
    ((8, 256, 256, 256), torch.bfloat16, True, None),
    ((8, 512, 256, 256), torch.bfloat16, True, None),
    ((8, 512, 128, 128), torch.bfloat16, True, None),
    ((8, 1024, 64, 64), torch.bfloat16, True, None),
    ((2, 64, 16, 128, 128), torch.bfloat16, True, None),
    ((2, 128, 16, 128, 128), torch.bfloat16, True, None),
]


def plan_for(shape, dtype, changes):
    b, c = shape[:2]
    s = math.prod(shape[2:])
    size = torch.empty((), dtype=dtype).element_size()
    plan = gn.forward_plan(b, s, c, 32, size)
    if not changes:
        return plan
    width = changes.get("width", plan.width)
    cluster = changes.get("cluster", plan.cluster)
    plan = dataclasses.replace(plan, **changes, units=b * c // width,
                               rows_per_block=math.ceil(s / cluster))
    cg = c // 32
    return dataclasses.replace(plan, smem_bytes=gn.forward_smem_bytes(
        width, width // cg, size, plan.slots, cluster, plan.halves))


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_gn_fwd needs a CUDA device", file=sys.stderr)
        return 1
    lib = gn.library(DEFINES)
    lib.gn_forward_trace.argtypes = [ctypes.c_void_p]
    lib.gn_forward_trace.restype = ctypes.c_int
    dev = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, dtype, swish, changes in CASES:
        b, c = shape[:2]
        x = torch.randn((b, *shape[2:], c), generator=gen, device="cuda") * 1.5 + 0.3
        x = x.to(dtype).movedim(-1, 1)
        w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.5 * torch.randn(c, generator=gen, device="cuda")
        plan = plan_for(shape, dtype, changes)
        fit = gn.forward_max_clusters(dev, dtype, swish, plan.cluster, plan.smem_bytes, DEFINES)
        clusters = min(plan.units, fit)
        blocks = clusters * plan.cluster
        trace = torch.zeros((blocks, UNITS, PHASES), dtype=torch.int64, device="cuda")
        for stamp in (False, False, True):
            if lib.gn_forward_trace(trace.data_ptr() if stamp else None):
                raise RuntimeError("gn_forward_trace failed")
            gn._launch_forward(x, w, bias, 32, 1e-6, swish, plan, DEFINES)
            torch.cuda.synchronize()
        lib.gn_forward_trace(None)
        n = min(math.ceil(plan.units / clusters), UNITS)
        t = trace[:, :n].double()
        t = (t - t[t > 0].min()) / 1e3  # µs from the first stamp
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"{shape} {name} swish={int(swish)}: {plan.describe()}; {clusters} clusters "
              f"launched, {fit} fit at once")
        d = t[..., 1:] - t[..., :-1]
        for k, what in enumerate(NAMES):
            print(f"  {what}: {float(d[..., k].mean()):.2f} us (slowest block "
                  f"{float(d[..., k].max(0).values.mean()):.2f})")
        starts = t[:, 0, 0]
        q = torch.quantile(starts, torch.tensor([0.25, 0.5, 0.75], dtype=torch.float64,
                                                device=starts.device))
        print(f"  span {float(t[..., 5].max()):.2f} us; block starts at the quartiles "
              f"{', '.join(f'{float(v):.2f}' for v in q)} us; a unit "
              f"{float((t[..., 5] - t[..., 0]).mean()):.2f} us")
        del x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
