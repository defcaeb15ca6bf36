"""Where a unit's time goes in kernel #2, the GroupNorm backward: a phase
clock read from a diagnostic build.

    python -m vqgan_tpu_torch.tools.trace_gn_bwd

Builds ``csrc/groupnorm.cu`` with ``-DGN_BWD_TRACE``, in which thread 0 of
every block stamps the global timer at the phase boundaries of each of its
first 64 units, and runs one backward call at each of a few flagship shapes
(batch 8: (65,536, 512) bf16 with and without the swish, (4,096, 1,024) bf16
with it, (65,536, 512) fp32 without), after two untimed calls. Prints, per
phase (waiting for the unit's x and g; dŷ and the sums; the block's partials;
the team's barrier; the group fold and the coefficients; dx and the next
unit's start), the mean over blocks and units and the mean of the slowest
block, then the mean unit. The stamps cost a few instructions a unit and
the build differs from the production library only by them. Needs a CUDA
device; fails without one.
"""

from __future__ import annotations

import ctypes
import math
import sys

import torch

from vqgan_tpu_torch.ops import groupnorm_cuda as gn
from vqgan_tpu_torch.ops.cuda_build import num_sms

DEFINES = ("-DGN_BWD_TRACE",)
UNITS, PHASES = 64, 6  # csrc/groupnorm.cu kTraceUnits, kTracePhases
CASES = [((8, 512, 256, 256), torch.bfloat16, True), ((8, 512, 256, 256), torch.bfloat16, False),
         ((8, 1024, 64, 64), torch.bfloat16, True), ((8, 512, 256, 256), torch.float32, False)]
NAMES = ("wait for x, g", "dy and sums", "block partials", "team barrier",
         "group fold + coefficients")


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_gn_bwd needs a CUDA device", file=sys.stderr)
        return 1
    lib = gn.library(DEFINES)
    lib.gn_backward_trace.argtypes = [ctypes.c_void_p]
    lib.gn_backward_trace.restype = ctypes.c_int
    dev = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, dtype, swish in CASES:
        b, c = shape[:2]
        x = torch.randn((b, *shape[2:], c), generator=gen, device="cuda") * 1.5 + 0.3
        g = torch.randn((b, *shape[2:], c), generator=gen, device="cuda")
        x, g = x.to(dtype).movedim(-1, 1), g.to(dtype).movedim(-1, 1)
        w = 1 + 0.5 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.5 * torch.randn(c, generator=gen, device="cuda")
        _, stats = gn.group_norm_forward(x, w, bias, 32, 1e-6, swish)
        per_sm = gn.backward_blocks_per_sm(dev, dtype, swish, DEFINES)
        plan = gn.backward_plan(b, math.prod(shape[2:]), c, 32, x.element_size(), num_sms(dev),
                                blocks_per_sm=per_sm)
        trace = torch.zeros((plan.grid, UNITS, PHASES), dtype=torch.int64, device="cuda")
        for stamp in (False, False, True):
            if lib.gn_backward_trace(trace.data_ptr() if stamp else None):
                raise RuntimeError("gn_backward_trace failed")
            gn._launch_backward(x, g, stats, w, bias, 32, swish, plan, DEFINES)
            torch.cuda.synchronize()
        lib.gn_backward_trace(None)
        n = min(plan.units // plan.teams, UNITS)
        t = trace[:, :n].double() / 1e3  # µs
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        print(f"{shape} {name} swish={int(swish)}: {plan.describe()}")
        d = t[:, 1:, 1:] - t[:, 1:, :-1]  # the units after the first
        for k, what in enumerate(NAMES):
            print(f"  {what}: {float(d[..., k].mean()):.2f} us (slowest block "
                  f"{float(d[..., k].max(0).values.mean()):.2f})")
        tail = t[:, 1:, 0] - t[:, :-1, 5]
        unit = t[:, 1:, 0] - t[:, :-1, 0]
        print(f"  dx + next unit's start: {float(tail.mean()):.2f} us; unit {float(unit.mean()):.2f}"
              f" us, {plan.units // plan.teams} units a team")
    return 0


if __name__ == "__main__":
    sys.exit(main())
