"""Train state and optimizers (counterpart of ``vqgan_tpu/train/state.py``).

The reference keeps G and D AdamW optimizers, a cosine-with-warmup schedule
on G and the LeCam EMA anchors beside its models (vae_trainer.py:455-490,
517-522). ``TrainState`` holds the same: the models (whose parameters the
optimizers update in place), the optimizers and G's scheduler, the anchors as
0-d device tensors, the step count, the step's ``torch.Generator`` on the
models' device, an optional Polyak-averaged copy of G's parameters and, for a
VQ latent with EMA, the codebook's EMA statistics. Sharded over the fsdp
mesh axis (``parallel/fsdp.py``) the state holds a rank's blocks between
steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from vqgan_tpu_torch.config import TrainConfig
from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.parallel.fsdp import Whole


@dataclasses.dataclass
class TrainState:
    step: int
    g_model: nn.Module
    g_opt: torch.optim.AdamW
    g_sched: Optional[LambdaLR]  # None for the 3D recon-only step's constant lr
    d_model: Optional[nn.Module]  # None when the GAN loss is off
    d_opt: Optional[torch.optim.AdamW]
    lecam_real: torch.Tensor
    lecam_fake: torch.Tensor
    generator: torch.Generator
    # Polyak-averaged G parameters by name (cfg.ema_decay > 0); None when off
    g_ema: Optional[dict[str, torch.Tensor]] = None
    # EMA codebook statistics {"counts": (K,), "sums": (K, D)}, fp32 on the
    # device (reg_type="vq" with vq_ema_decay > 0); None otherwise
    vq_ema: Optional[dict[str, torch.Tensor]] = None
    # the layout (``parallel/fsdp.py``): ``Whole``, or ``FSDP``, with which
    # each >= 2-D tensor its rule splits is this rank's block between steps
    layout: Whole = dataclasses.field(default_factory=Whole)


def hf_cosine_schedule(base_lr: float, warmup_steps: int,
                       total_steps: int) -> Callable[[int], float]:
    """HF transformers' get_cosine_schedule_with_warmup (vae_trainer.py:486-490):
    linear warmup from 0, then a half cosine to 0."""

    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return fn


def _is_conv_in(name: str) -> bool:
    """Any component of the parameter's path is ``conv_in`` (both
    ``encoder.conv_in.*`` and ``decoder.conv_in.*``)."""
    return "conv_in" in name.split(".")


def make_generator_optimizer(cfg: TrainConfig, vae_ch: int,
                             g_model: nn.Module) -> tuple[torch.optim.AdamW, LambdaLR]:
    """Two param groups (vae_trainer.py:455-468): lr = learning_rate_vae /
    vae_ch for everything but the conv_in layers, which get a fixed 1e-4; both
    follow the cosine schedule (LambdaLR steps every group). AdamW decays every
    parameter, wd 1e-3, betas (0.9, 0.95). The lr at step 0 is 0."""
    named = list(g_model.named_parameters())
    opt = torch.optim.AdamW(
        [
            {"params": [p for n, p in named if not _is_conv_in(n)],
             "lr": cfg.learning_rate_vae / vae_ch},
            {"params": [p for n, p in named if _is_conv_in(n)], "lr": 1e-4},
        ],
        betas=(cfg.beta1, cfg.beta2),
        weight_decay=cfg.weight_decay,
    )
    sched = LambdaLR(opt, hf_cosine_schedule(1.0, cfg.warmup_steps, cfg.max_steps))
    return opt, sched


def make_discriminator_optimizer(cfg: TrainConfig, d_model: nn.Module) -> torch.optim.AdamW:
    """AdamW at a constant lr (no scheduler on D; vae_trainer.py:470-475)."""
    return torch.optim.AdamW(
        d_model.parameters(),
        lr=cfg.learning_rate_disc,
        betas=(cfg.beta1, cfg.beta2),
        weight_decay=cfg.weight_decay,
    )


def make_recon_optimizer(cfg: TrainConfig, vae_ch: int, g_model: nn.Module
                         ) -> torch.optim.AdamW:
    """The 3D recon-only step's optimizer (``vqgan_tpu/train/trainer3d.py:
    271-275``): one AdamW over every parameter at the constant lr
    learning_rate_vae / vae_ch, no conv_in group, no schedule."""
    return torch.optim.AdamW(
        g_model.parameters(),
        lr=cfg.learning_rate_vae / vae_ch,
        betas=(cfg.beta1, cfg.beta2),
        weight_decay=cfg.weight_decay,
    )


def to_channels_last(model: nn.Module) -> None:
    """Each 4-D parameter or buffer of ``model`` into ``torch.channels_last``
    and each 5-D one into ``torch.channels_last_3d`` (what the convs and the
    kernels read), in place; ``Module.to(memory_format=...)`` takes one format
    for both ranks and refuses a 5-D weight with the 4-D one."""
    formats = {4: torch.channels_last, 5: torch.channels_last_3d}
    with torch.no_grad():
        for m in model.modules():
            for p in m.parameters(recurse=False):
                if p.ndim in formats:
                    p.data = p.data.contiguous(memory_format=formats[p.ndim])
            for name, buf in m.named_buffers(recurse=False):
                if buf.ndim in formats:
                    setattr(m, name, buf.contiguous(memory_format=formats[buf.ndim]))


def create_train_state(
    cfg: TrainConfig,
    g_model: nn.Module,
    d_model: Optional[nn.Module],
    vae_ch: int,
    seed: int = 0,
    vq_ema: Optional[dict[str, torch.Tensor]] = None,
    recon_only: bool = False,
) -> TrainState:
    """The state of a fresh run. The models must already sit on their device;
    their params are put in the channels-last format of their rank
    (``to_channels_last``), then handed to the optimizers: G's two-group
    AdamW with the cosine schedule, or with ``recon_only`` (the 3D
    recon-only step; no D) the constant-lr ``make_recon_optimizer``.

    A VQ generator with EMA gets its EMA statistics: ``vq_ema`` moved to the
    device when given, else the JAX init's counts 1 and sums = the codebook
    (``vqgan_tpu/models/quant.py:93-98``, ``trainer.py:98``)."""
    if recon_only and d_model is not None:
        raise ValueError("recon_only: the recon-only step has no discriminator")
    to_channels_last(g_model)
    device = next(g_model.parameters()).device
    if recon_only:
        g_opt, g_sched = make_recon_optimizer(cfg, vae_ch, g_model), None
    else:
        g_opt, g_sched = make_generator_optimizer(cfg, vae_ch, g_model)
    d_opt = None
    if d_model is not None:
        to_channels_last(d_model)
        d_opt = make_discriminator_optimizer(cfg, d_model)
    g_ema = None
    if cfg.ema_decay > 0 and not recon_only:  # the JAX recon-only step keeps none
        # starts at the initial weights (Polyak convention)
        g_ema = {n: p.detach().clone() for n, p in g_model.named_parameters()}
    reg = getattr(g_model, "reg", None)
    if isinstance(reg, VectorQuantizer) and reg.ema_decay > 0:
        vq_ema = (reg.init_ema() if vq_ema is None
                  else {k: v.to(device, torch.float32) for k, v in vq_ema.items()})
    elif vq_ema is not None:
        raise ValueError("vq_ema given, but the generator has no VQ latent with EMA")
    return TrainState(
        step=0,
        g_model=g_model,
        g_opt=g_opt,
        g_sched=g_sched,
        d_model=d_model,
        d_opt=d_opt,
        lecam_real=torch.zeros((), device=device),
        lecam_fake=torch.zeros((), device=device),
        generator=torch.Generator(device=device).manual_seed(seed),
        g_ema=g_ema,
        vq_ema=vq_ema,
    )


def state_tensors(state: TrainState, sharded: Optional[bool] = None) -> list[torch.Tensor]:
    """Every tensor of the train state that this rank holds, in a fixed
    order: G's and D's parameters and buffers, their optimizers'
    per-parameter state, the LeCam anchors, the generator's state, the
    Polyak and VQ EMAs. Equal on every rank of a data-parallel job; under
    fsdp a sharded tensor is this rank's block, equal on the ranks of its
    fsdp index. ``sharded``: only the blocks (True) or only the whole
    tensors (False)."""
    is_block = state.layout.is_block
    items: list[tuple[torch.Tensor, bool]] = []
    for model, opt in ((state.g_model, state.g_opt), (state.d_model, state.d_opt)):
        if model is None:
            continue
        items += [(t.detach(), is_block(t)) for t in model.parameters()]
        items += [(t, False) for t in model.buffers()]
        for group in opt.param_groups:
            for p in group["params"]:
                per = opt.state.get(p, {})
                items += [(per[k], is_block(p) and per[k].ndim >= 2) for k in sorted(per)
                          if isinstance(per[k], torch.Tensor)]
    items += [(state.lecam_real, False), (state.lecam_fake, False),
              (state.generator.get_state(), False)]
    for prefix, tree in (("g_model", state.g_ema), ("vq_ema", state.vq_ema)):
        if tree is not None:
            items += [(tree[k], is_block(path=f"{prefix}.{k}")) for k in sorted(tree)]
    return [t for t, block in items if sharded is None or block == sharded]
