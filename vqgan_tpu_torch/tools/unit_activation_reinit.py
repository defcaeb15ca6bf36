"""muP-style unit-activation weight-init calibrator (counterpart of
``tools/unit_activation_reinit.py``; the reference's standalone tool,
unit_activation_reinitializer.py:9-110): measure every layer's output
standard deviation on one batch, then rescale each conv kernel, iteration
by iteration, until its output has about unit std, starting from a muP
1/sqrt(fan_in) init.

The JAX tool records every module's output functionally
(``capture_intermediates``); this one puts a forward hook on every module,
as the reference's tool did. The parameters live in the model, which is
changed in place. The JAX tool's arguments map as: ``params`` → the model's
own, ``rngs`` → ``eps`` (the sampled Gaussian latent's ε; the default
deterministic latent needs none), ``rng`` → ``generator``. Layer names are
the model's module names, the reference's (``encoder.down.0.block.0.conv1``
for JAX's ``encoder/down_0/block_0/conv1``). On the card the forwards run
the GroupNorm forward kernel.

    python -m vqgan_tpu_torch.tools.unit_activation_reinit [--device cpu]

calibrates a small VAE (the JAX tool's ``__main__`` config) on a random
batch and prints each layer's initial and final std.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import torch
import torch.nn as nn


def _kernels(model: nn.Module) -> dict[str, torch.Tensor]:
    """The conv kernels of ``model`` by module name: each module's own
    ``weight`` of rank >= 2 (JAX's ``kernel`` leaves)."""
    out = {}
    for name, m in model.named_modules():
        w = m._parameters.get("weight")
        if w is not None and w.ndim >= 2:
            out[name] = w
    return out


@torch.no_grad()
def mup_reinit(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every conv kernel drawn anew as N(0, 1/fan_in) from ``generator``
    (fan_in: the input channels times the window), in module order; every
    bias zeroed; the rest (GroupNorm scales, a codebook) kept. In place;
    returns ``model`` (reference unit_activation_reinitializer.py:74-87)."""
    for w in _kernels(model).values():
        fan_in = w[0].numel()
        w.copy_(torch.randn(w.shape, generator=generator, device=generator.device,
                            dtype=w.dtype) / fan_in ** 0.5)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] == "bias":
            p.zero_()
    return model


@torch.no_grad()
def compute_activation_std(model: nn.Module, batch: torch.Tensor,
                           eps: Optional[torch.Tensor] = None) -> dict[str, float]:
    """Each module's output std (population, in fp32) on one forward of
    ``batch``, by module name; a module called more than once is read at its
    first call, and outputs of one element or not tensors are left out
    (reference unit_activation_reinitializer.py:9-57)."""
    outputs: dict[str, torch.Tensor] = {}
    hooks = []
    for name, m in model.named_modules():
        if not name:
            continue

        def hook(module, inputs, output, name=name):
            if name not in outputs and isinstance(output, torch.Tensor) and output.numel() > 1:
                outputs[name] = output.detach()

        hooks.append(m.register_forward_hook(hook))
    try:
        model(batch) if eps is None else model(batch, eps)
    finally:
        for h in hooks:
            h.remove()
    return {name: float(out.float().std(correction=0)) for name, out in outputs.items()}


@torch.no_grad()
def adjust_weight_init(
    model: nn.Module,
    batch: torch.Tensor,
    eps: Optional[torch.Tensor] = None,
    tol: float = 0.1,
    max_iters: int = 10,
    use_mup_start: bool = True,
    generator: Optional[torch.Generator] = None,
    verbose: bool = False,
) -> tuple[nn.Module, dict[str, dict[str, float]]]:
    """Rescale the conv kernels toward unit activation std, in place
    (reference unit_activation_reinitializer.py:60-110): each iteration
    divides a kernel by its layer's output std where that std is more than
    ``tol`` from 1, until the worst layer is within ``tol`` or after
    ``max_iters``. Returns (the model, the report ``{layer:
    {"initial_act_std", "final_act_std"}}``), the JAX tool's keys."""
    if use_mup_start:
        if generator is None:
            generator = torch.Generator(next(model.parameters()).device).manual_seed(0)
        mup_reinit(model, generator)
    report = {name: {"initial_act_std": s}
              for name, s in compute_activation_std(model, batch, eps).items()}
    kernels = _kernels(model)
    for it in range(max_iters):
        stds = compute_activation_std(model, batch, eps)
        worst = 0.0
        for name, act_std in stds.items():
            if name not in kernels or act_std <= 0:
                continue  # only rescale parametric (conv) layers
            dev = abs(act_std - 1.0)
            worst = max(worst, dev)
            if dev > tol:
                kernels[name].div_(act_std)
        if verbose:
            print(f"iter {it}: worst |std-1| = {worst:.3f}", file=sys.stderr)
        if worst <= tol:
            break
    for name, s in compute_activation_std(model, batch, eps).items():
        if name in report:
            report[name]["final_act_std"] = s
    return model, report


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max_iters", type=int, default=8)
    args = ap.parse_args(argv)

    from vqgan_tpu_torch.config import VAEConfig
    from vqgan_tpu_torch.models.ae import init_vae

    device = torch.device(args.device)
    cfg = VAEConfig(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                    enc_dtype="float32", dec_dtype="float32")
    with torch.device(device):
        model = init_vae(cfg, torch.Generator(device).manual_seed(0))
    batch = torch.randn((8, 32, 32, 3), generator=torch.Generator(device).manual_seed(1),
                        device=device)
    _, report = adjust_weight_init(model, batch, tol=0.1, max_iters=args.max_iters,
                                   verbose=True)
    for layer, stats in sorted(report.items()):
        if "final_act_std" in stats:
            print(f"{layer}: {stats['initial_act_std']:.3f} -> {stats['final_act_std']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
