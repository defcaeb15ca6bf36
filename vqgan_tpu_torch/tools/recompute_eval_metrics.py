"""Recompute eval PSNR/SSIM (and fixed-judge LPIPS) offline from a run's
saved ``.pt`` checkpoints (counterpart of ``tools/recompute_eval_metrics.py``).

Replays the trainer's eval contract against each checkpoint: the same
cached first-N batches of the just-resize test stream at the base seed
(``train/trainer.py::_make_loader``), the same eval step
(``train/evaluate.py::make_eval_step``: bf16 encoder and decoder with
``eval_bf16``, the GroupNorm forward kernel on the card), PSNR and SSIM from
``losses/metrics.py``; prints one JSON line a checkpoint, in step order:

    python -m vqgan_tpu_torch.tools.recompute_eval_metrics \\
        --ckpt_glob 'ckpt/run/vae_epoch_*_step_*.pt' \\
        --test_dataset_url 'shards/00003.tar' [--judge_lpips default,alt.npz] \\
        [--device cpu]

The options are the JAX tool's, with ``--device`` (the card by default).
``--judge_lpips`` scores ``eval/lpips_judge`` under fixed LPIPS nets, comma
separated: a converted weight file (``.npz`` or ``.pth``, what
``--lpips_weights`` reads), or ``default``, the net a run of this package
without ``--lpips_weights`` trains against: ``init_lpips_`` drawn from the
trainer's LPIPS seed (the third word of ``SeedSequence(seed)``,
``train/trainer.py``). That is not the JAX package's ``default`` judge,
which its PRNG draws, so a ``default`` column compares checkpoints of this
package's runs only; a weight file gives both packages the same judge. Two
judges of one name (two files of one stem, or a file named ``default``)
raise an error instead of sharing a column.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Callable, Optional

import numpy as np
import torch


def judge_names(spec: str) -> list[tuple[str, Optional[str]]]:
    """``--judge_lpips``'s judges as (column name, weight file or None for
    ``default``); a name twice raises ValueError."""
    judges: list[tuple[str, Optional[str]]] = []
    for item in spec.split(","):
        item = item.strip()
        path = None if item == "default" else item
        name = "default" if path is None else os.path.splitext(os.path.basename(path))[0]
        if name in (n for n, _ in judges):
            raise ValueError(f"--judge_lpips {spec!r}: two judges named {name!r} would share "
                             f"one column; rename one file")
        judges.append((name, path))
    return judges


def make_judges(spec: str, seed: int, device: torch.device) -> dict[str, Callable]:
    """``{column name: (a, b) -> mean LPIPS}`` of fp32 judge nets."""
    from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
    from vqgan_tpu_torch.weights import load_lpips_weights

    s_lpips = int(np.random.SeedSequence(seed).generate_state(4)[2])
    judges = {}
    for name, path in judge_names(spec):
        with torch.device(device):
            net = LPIPS(torch.float32)  # fp32 judge for metric stability
        if path is None:
            init_lpips_(net, torch.Generator(device=device).manual_seed(s_lpips))
        else:
            net.load_state_dict(load_lpips_weights(path), strict=True)

        def judge(a, b, _net=net):
            with torch.no_grad():
                return _net(a, b).mean()

        judges[name] = judge
    return judges


def _step_of(path: str) -> int:
    return int(re.search(r"step_(\d+)", path).group(1))


def recompute(args: argparse.Namespace) -> list[dict]:
    from vqgan_tpu_torch.config import TrainConfig, VAEConfig
    from vqgan_tpu_torch.data.loader import create_dataloader, to_device
    from vqgan_tpu_torch.losses.metrics import psnr, ssim
    from vqgan_tpu_torch.models.ae import VAE
    from vqgan_tpu_torch.train.evaluate import make_eval_step
    from vqgan_tpu_torch.weights import load_weights

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch; pass --device cpu")
    cfg = TrainConfig(run_name="recompute", dataset_url=args.test_dataset_url,
                      test_dataset_url=args.test_dataset_url, batch_size=args.batch_size,
                      eval_batches=args.eval_batches, image_size=args.image_size,
                      seed=args.seed)
    vae_cfg = VAEConfig(ch=args.vae_ch, ch_mult=tuple(int(x) for x in args.vae_ch_mult.split(",")),
                        z_channels=args.vae_z_channels, resolution=args.vae_resolution)
    judges = make_judges(args.judge_lpips, args.seed, device) if args.judge_lpips else {}
    paths = sorted(glob.glob(args.ckpt_glob), key=_step_of)
    if not paths:
        raise SystemExit(f"no checkpoints match {args.ckpt_glob}")
    with torch.device(device):
        model = VAE(vae_cfg)
    eval_step = make_eval_step(cfg, vae_cfg, model)
    del model  # the eval step keeps its own model in the eval dtypes

    # the trainer's fixed eval set: the first N batches of the just-resize
    # test stream at the base seed
    loader = iter(create_dataloader(args.test_dataset_url, args.batch_size, num_workers=2,
                                    do_shuffle=False, just_resize=True, width=args.image_size,
                                    seed=args.seed, device_normalize=cfg.device_normalize,
                                    indexed=False))
    batches = [to_device(next(loader), device) for _ in range(args.eval_batches)]

    rows = []
    for path in paths:
        params = {k: v.to(device) for k, v in load_weights(path).items()}
        pairs = [eval_step(params, batch) for batch in batches]
        recon = torch.cat([r for r, _ in pairs])
        target = torch.cat([t for _, t in pairs])
        row = {"step": _step_of(path), "eval/psnr": float(psnr(recon, target)),
               "eval/ssim": float(ssim(recon, target))}
        for name, judge in judges.items():
            key = ("eval/lpips_judge" if len(judges) == 1 and name == "default"
                   else f"eval/lpips_judge_{name}")
            row[key] = float(judge(recon * 2.0 - 1.0, target * 2.0 - 1.0))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt_glob", required=True)
    ap.add_argument("--test_dataset_url", required=True)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--eval_batches", type=int, default=2)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--vae_ch", type=int, default=256)
    ap.add_argument("--vae_ch_mult", default="1,2,4,4")
    ap.add_argument("--vae_z_channels", type=int, default=16)
    ap.add_argument("--vae_resolution", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--judge_lpips", default=None,
                    help="Also score eval/lpips_judge under fixed judge net(s): 'default' (the "
                         "net a run without --lpips_weights trains against) or converted "
                         "weights (.npz/.pth), comma separated; names must differ")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    recompute(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
