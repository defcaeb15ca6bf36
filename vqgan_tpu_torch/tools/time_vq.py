"""Time kernels #4 and #5, the VQ nearest-code search and code statistics,
as the wrappers run them, at every shape ``chip_smoke.py`` checks them at:
for comparing two trees in one call on one card (parent, change, change,
parent: run it from each checkout's root in turn; it needs nothing of the
tree but ``ops/vq_cuda.nearest_codes`` / ``code_stats`` and
``tools/sweep_conv3d.device_ms``).

    python -m vqgan_tpu_torch.tools.time_vq [--tag NAME] [--iters 20] [--kernel_only] [--profile]

The shapes: ``chip_smoke.VQ_CASES`` (the flagship VQ step's N = 8,192 and
2,048 tokens against K = 16,384 codes at D = 16, and three small ones), the
statistics on the plain search's codes there, and at the flagship b8 shape
on Zipf-skewed codes and on a collapsed codebook (every token on one code).
One line a case: each kernel's device time (CUDA graph replays) and, unless
``--kernel_only``, the plain version's and the library call's
(``addmm`` + ``argmin``; ``index_add_``). The inputs come from one seed, so
two trees see the same data. ``--profile`` adds, for each case, the device
time of every kernel a call launches, from a torch.profiler trace of
``--iters`` calls. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import re
import sys

import torch

# (N, K, D), as chip_smoke.VQ_CASES
CASES = {
    "flagship b8": (8192, 16384, 16), "flagship b2": (2048, 16384, 16),
    "ragged N": (700, 256, 16), "K tiles": (512, 2048, 8), "small K": (64, 32, 4),
}


def zipf_codes(n, k, gen) -> torch.Tensor:
    """Zipf-skewed codes (exponent 1.3): a few codes take most tokens, as a
    collapsing codebook's do (chip_smoke.py's phase 9 draws them here too)."""
    u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
    # inverse transform of a continuous power law, floored: P(code >= c) ~ c^-0.3
    codes = torch.floor(u.clamp_min(1e-300) ** (-1 / 0.3)) - 1
    return codes.clamp(0, k - 1).to(torch.int32)


def kernel_us(fn, iters: int) -> str:
    """µs a call of each VQ kernel that ``fn`` launches, from a torch.profiler
    trace of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    from vqgan_tpu_torch.tools.profile_serving import device_kernels

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per: dict = {}
    for e in device_kernels(prof):
        found = re.search(r"vq_\w+(<[^>]*>)?", e.name)
        if found:
            name = found.group(0)
            per[name] = per.get(name, 0.0) + e.time_range.end - e.time_range.start
    return ", ".join(f"{name} {us / iters:.2f} us" for name, us in per.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--kernel_only", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_vq needs a CUDA device", file=sys.stderr)
        return 1
    from vqgan_tpu_torch.ops import vq_cuda
    from vqgan_tpu_torch.ops.vq import code_stats_plain, nearest_codes_plain
    from vqgan_tpu_torch.tools.sweep_conv3d import device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def stats_line(name, codes, z, k):
        codes64 = codes.long()
        ones = torch.ones(codes.shape[0], device="cuda")
        parts = []
        for with_sums in (False, True):
            kind = "sums" if with_sums else "counts"
            ms = device_ms(lambda: vq_cuda.code_stats(codes, z, k, with_sums=with_sums),
                           args.iters)
            parts.append(f"stats {kind} kernel {ms:.4f} ms")
            if not args.kernel_only:
                p = device_ms(lambda: code_stats_plain(codes, z, k, with_sums), 5)

                def library():
                    counts = torch.zeros(k, device="cuda").index_add_(0, codes64, ones)
                    if with_sums:
                        torch.zeros(k, z.shape[1], device="cuda").index_add_(0, codes64, z)
                    return counts

                parts.append(f"plain {p:.4f} ms, index_add_ {device_ms(library, 5):.4f} ms")
        n, d = z.shape
        print(f"{args.tag} vq {name} N={n} K={k} D={d}: " + "; ".join(parts), flush=True)
        if args.profile:
            print(f"{args.tag} vq {name} stats sums kernels: " + kernel_us(
                lambda: vq_cuda.code_stats(codes, z, k, with_sums=True), args.iters), flush=True)

    for name, (n, k, d) in CASES.items():
        z = torch.randn((n, d), generator=gen, device="cuda")
        cb = torch.randn((k, d), generator=gen, device="cuda")
        ms = device_ms(lambda: vq_cuda.nearest_codes(z, cb), args.iters)
        line = f"{args.tag} vq {name} N={n} K={k} D={d}: search kernel {ms:.4f} ms"
        if not args.kernel_only:
            e_sq = (cb * cb).sum(-1)
            p = device_ms(lambda: nearest_codes_plain(z, cb), 5)
            lib = device_ms(lambda: torch.addmm(e_sq, z, cb.T, alpha=-2.0).argmin(1), 5)
            line += f", plain {p:.4f} ms, addmm + argmin {lib:.4f} ms"
        print(line, flush=True)
        if args.profile:
            print(f"{args.tag} vq {name} search kernels: "
                  + kernel_us(lambda: vq_cuda.nearest_codes(z, cb), args.iters), flush=True)
        stats_line(name, nearest_codes_plain(z, cb), z, k)
        del z, cb
        torch.cuda.empty_cache()
    n, k, d = CASES["flagship b8"]
    z = torch.randn((n, d), generator=gen, device="cuda")
    stats_line("zipf", zipf_codes(n, k, gen), z, k)
    stats_line("collapsed", torch.full((n,), 5, dtype=torch.int32, device="cuda"), z, k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
