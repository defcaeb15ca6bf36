"""The end-to-end readouts of one tree, for comparing two trees in one call
on one card (parent, change, change, parent: run it from each checkout's
root in turn).

    python -m vqgan_tpu_torch.tools.readouts [--tag NAME]

Prints three lines: the flagship training step at batch 8 (bf16, as
``tools/profile_step.py`` builds it; ms a step by the host clock over 5
steps after 3, ending in a fetch of the loss, and between CUDA events over
the same steps), flagship serving at batch 8 (``VAEPipeline.reconstruct``
of random weights, img/s by the host clock over 3 reconstructs after 2) and
the 3D recon-only step at 16 frames x 128 px, batch 2 (as the step). TF32 on
for convs, off for matmuls. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def timed(run, fetch, iters: int) -> tuple[float, float]:
    """(host ms, CUDA-event ms) a call of ``run`` over ``iters`` calls; the
    host clock stops after ``fetch`` of the last result."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        last = run()
    end.record()
    fetch(last)
    host = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return host, start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readouts needs a CUDA device", file=sys.stderr)
        return 1
    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.inference import VAEPipeline
    from vqgan_tpu_torch.models.ae import init_vae
    from vqgan_tpu_torch.tools.profile_step import build_flagship_step, build_step3d

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    state, step, images = build_flagship_step(8)
    for _ in range(3):
        state, metrics = step(state, images)
    float(metrics["overall_vae_loss"])
    host, dev = timed(lambda: step(state, images), lambda r: float(r[1]["overall_vae_loss"]), 5)
    print(f"{args.tag} flagship step: host {host:.2f} ms, device-events {dev:.2f} ms", flush=True)
    del state, step, images
    torch.cuda.empty_cache()

    cfg = VAEConfig()
    pipe = VAEPipeline(cfg, init_vae(cfg, torch.Generator().manual_seed(0)).state_dict(),
                       device="cuda")
    batch = np.random.RandomState(0).randint(0, 256, (8, 256, 256, 3), np.uint8)
    for _ in range(2):
        pipe.reconstruct(batch)
    host, _ = timed(lambda: pipe.reconstruct(batch), lambda r: None, 3)
    print(f"{args.tag} flagship serving: {8 / host * 1e3:.2f} img/s (host {host:.2f} ms a "
          f"reconstruct)", flush=True)
    del pipe
    torch.cuda.empty_cache()

    state, step, _, _, source = build_step3d(2)
    clips = next(source)
    for _ in range(3):
        state, metrics = step(state, clips)
    float(metrics["loss"])
    host, dev = timed(lambda: step(state, clips), lambda r: float(r[1]["loss"]), 5)
    print(f"{args.tag} 3D recon step: host {host:.2f} ms, device-events {dev:.2f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
