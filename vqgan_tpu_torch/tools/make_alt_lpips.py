"""Write an alternate random perceptual-net weight file (counterpart of
``tools/make_alt_lpips.py``): a seeded random LPIPS, its VGG16 drawn by
``init_lpips_``'s scheme from ``--seed`` and its five lin heads random, in
the flat ``a/b/c`` ``.npz`` layout of converted LPIPS params that both
packages' ``--lpips_weights`` read (``vqgan_tpu_torch/weights.py::
load_lpips_weights``, ``vqgan_tpu/losses/lpips.py::load_lpips_params``). A
run launched with ``--lpips_weights <out>`` trains against another
perceptual net than the default one, everything else the same; the
recompute tool's ``--judge_lpips <out>`` scores checkpoints under it.

    python -m vqgan_tpu_torch.tools.make_alt_lpips --seed 7 --out alt_lpips_seed7.npz

Two differences from the JAX tool: the weights are drawn by this package's
``losses/lpips.py`` and written directly (the JAX tool built the
reference's LPIPS module and converted its state dict), and the lin heads
are non-negative, uniform in [0, 2/C) (mean 1/C, the default head), where
the reference's signed init gives heads that make LPIPS negative. CPU only.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch


def alt_lpips_state_dict(seed: int) -> dict[str, torch.Tensor]:
    """A seeded random LPIPS state dict (the port's key names): the VGG by
    ``init_lpips_``, then each head uniform in [0, 2/C), from one generator."""
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.losses.vgg import TAP_CHANNELS

    gen = torch.Generator().manual_seed(seed)
    net = LPIPS()
    init_lpips_(net, gen)
    with torch.no_grad():
        for k, c in enumerate(TAP_CHANNELS):
            head = getattr(net, f"lin{k}").model[1].weight
            head.copy_(torch.rand(head.shape, generator=gen) * (2.0 / c))
    return net.state_dict()


def write_alt_lpips(seed: int, out: str) -> int:
    """The ``.npz`` of ``alt_lpips_state_dict(seed)`` at ``out``; returns
    the number of arrays."""
    from vqgan_tpu_torch.weights import lpips_state_dict_to_jax

    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(lpips_state_dict_to_jax(alt_lpips_state_dict(seed)), "")
    np.savez(out, **flat)
    return len(flat)


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default="alt_lpips.npz")
    args = ap.parse_args(argv)
    from vqgan_tpu_torch.weights import load_lpips_weights

    n = write_alt_lpips(args.seed, args.out)
    load_lpips_weights(args.out)
    print(f"wrote {args.out} ({n} arrays, seed {args.seed}), verified by load_lpips_weights")
    return 0


if __name__ == "__main__":
    sys.exit(main())
