"""The train steps of the 3D video VAE (TVAE): recon-only and full GAN
(counterparts of ``vqgan_tpu/train/trainer3d.py::make_train_step_3d`` and
``vqgan_tpu/train/step3d.py::make_train_step_3d_gan``).

Clips are (B, T, H, W, 3) floats in [-1, 1]. The latent is the
reparameterized Gaussian (``models/tae.py::reparameterize``: a sample and its
KL) or the VQ latent (its ``vq_loss`` in the KL's place, the EMA statistics
of the one generator forward). Unlike the 2D step there is no input flip, no
latent crop and no z clamp.

The recon-only step: L2 + ``z_reg_weight``·KL, one backward, the
constant-lr AdamW (``create_train_state(..., recon_only=True)``), then with
VQ EMA the codebook fold and dead-code revival.

The GAN step, in order (the JAX order):

  - one generator forward, encode → latent → decode; its graph stays alive;
  - with ``do_ganloss``: D's update before G, on ``recon.detach()`` and the
    clip in fp32. D sees a frame subset (``frame_subset``, the
    ``video_loss_frames`` phase drawn once a step): the frame disc as a
    (B·k) frame batch, the tubelet disc as the (B, k) clip;
  - G's losses against the updated D, D's params frozen: LPIPS on the same
    frame subset, L2 on every frame, each branch through its GradNorm, plus
    ``z_reg_weight``·KL and the hinge/BCE GAN branch on that subset;
  - one backward, G's AdamW step and its scheduler step;
  - VQ with EMA: the fold and the revival; then the Polyak EMA.

With ``grad_accum`` = k > 1 the clip batch is k microbatches and the step
is one step at the whole batch, as the 2D ``step_accum`` (``train/step.py``):
the recon-only step takes each microbatch's forward and backward and one
AdamW step on the mean gradient (JAX ``trainer3d.py:115-150``); the GAN step
runs D's pass (each microbatch's generator forward without autograd, VQ
without statistics as JAX's ``gen_forward_nostats``, D's mean gradient, the
anchors a microbatch at a time, one D step), then G's pass against the
updated D (JAX ``step3d.py:333-494``). The VQ statistics run through the
microbatches of the one pass that takes them; revival samples every
microbatch's z. With ``tvae_cfg.remat`` LPIPS and D are rematerialized
regions too.

Randomness: ε, the frame phase u and the revival rows are drawn from the
state's ``torch.Generator`` on the device, or given as ``Step3DDraws`` (the
parity tests feed the JAX step's). Under accumulation one phase u serves the
step, microbatch i takes rows [i·B/k, (i+1)·B/k) of ε in both passes (drawn
a microbatch at a time when not given), and the revival rows index the z of
the whole batch.

Data parallelism (``group``): as the 2D step (``train/step.py``), each rank
holds its B clips of a global batch of N·B and the step is the one-process
step on it. The losses enter the backward over N, the gradients are summed
across the ranks, GradNorm takes the global norm, the LeCam anchors the
global mean logits, VQ the summed counts and sums; the phase u is drawn
once from the same generator state on every rank, ε and the revival rows
for the global batch (a rank takes its rows of ε), and every metric is the
mean over the ranks. Sharded over fsdp (``state.layout``) G and D are
gathered at the start, each AdamW steps on this rank's blocks and the step
ends on the blocks, as in the 2D step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn as nn

from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
from vqgan_tpu_torch.losses.gan import generator_gan_loss
from vqgan_tpu_torch.models.blocks import remat_call
from vqgan_tpu_torch.models.tae import reparameterize
from vqgan_tpu_torch.parallel.mesh import group_size
from vqgan_tpu_torch.train.state import TrainState
from vqgan_tpu_torch.train.step import (
    GradMean,
    backward_share,
    discriminator_update,
    fold_codebook,
    frozen,
    global_metrics,
    global_rows,
    gradnorm_branch,
    mean_metrics,
    microbatches,
    optimizer_step,
    polyak_update,
    rank_rows,
)


@dataclasses.dataclass
class Step3DDraws:
    """One 3D step's random draws; any left None is drawn from the state's
    generator. ``eps``: the Gaussian's ε, shaped like the latent's mean (B,
    t, h, w, z_channels), fp32; ``frame_u``: the frame subset's phase in
    [0, 1), a float or a 0-d fp32 tensor; ``revive_idx``: the (K,) int64
    rows of the step's flat z that dead codes take."""

    eps: Optional[torch.Tensor] = None
    frame_u: Any = None
    revive_idx: Optional[torch.Tensor] = None


def frame_subset(arrays: Sequence[torch.Tensor], k: int, u) -> tuple[torch.Tensor, ...]:
    """``k`` evenly strided frames of each (B, T, ...) array with the phase
    u: frame floor((i + u)·T/k) for i < k, in fp32 as JAX's
    ``_frame_subset`` computes it (``step3d.py:42-57``). k <= 0 or k >= T
    keeps every frame."""
    t = arrays[0].shape[1]
    if k <= 0 or k >= t:
        return tuple(arrays)
    device = arrays[0].device
    u = torch.as_tensor(u, dtype=torch.float32, device=device)
    idx = ((torch.arange(k, device=device) + u) * (t / k)).floor().long()
    return tuple(a.index_select(1, idx) for a in arrays)


def flat_frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) → (B·T, H, W, C) for the 2D loss modules."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _check(cfg: TrainConfig, tvae_cfg: TVAEConfig) -> None:
    if cfg.gradnorm_mode not in ("global", "mean_shard_norm"):
        raise ValueError(f"unknown gradnorm_mode {cfg.gradnorm_mode!r}")
    if tvae_cfg.reg_type not in ("gaussian", "vq"):
        raise ValueError(f"unknown reg_type {tvae_cfg.reg_type!r}")


class _Latent:
    """The regularizer of one step and its draws: the Gaussian's sample and
    KL, or the VQ latent with its loss and new EMA statistics."""

    def __init__(self, tvae_cfg: TVAEConfig, model: nn.Module, group=None, accum: int = 1):
        self.model = model
        self.group = group
        self.n_ranks = group_size(group)
        self.accum = accum
        self.gaussian = tvae_cfg.reg_type == "gaussian"
        self.use_vq_ema = not self.gaussian and tvae_cfg.vq_ema_decay > 0
        self.revive_threshold = tvae_cfg.vq_revive_threshold if self.use_vq_ema else 0.0
        self.codebook_size = tvae_cfg.vq_codebook_size

    def __call__(self, z: torch.Tensor, generator: torch.Generator,
                 vq_ema: Optional[dict], draws: Step3DDraws, stats: bool = True):
        """→ (z_s, reg_loss, new_ema or None); fills ``draws.eps``.
        ``stats=False`` (D's pass under accumulation): VQ quantizes without
        its loss and statistics (reg_loss None)."""
        if self.gaussian:
            if draws.eps is None:
                # the global batch's ε from the shared generator state
                eps = torch.randn(z.shape[0] * self.n_ranks, *z.shape[1:-1], z.shape[-1] // 2,
                                  generator=generator, device=z.device)
                draws.eps = rank_rows(eps, self.group)
            z_s, kl = reparameterize(z, draws.eps)
            return z_s, kl, None
        if not stats:
            return self.model.reg.quantize(z), None, None
        z_s, aux, new_ema = self.model.regularize(z, vq_ema, self.use_vq_ema, self.group)
        return z_s, aux["vq_loss"], new_ema

    def fold(self, state: TrainState, new_ema, z: torch.Tensor, draws: Step3DDraws) -> None:
        """The EMA fold and dead-code revival after G's AdamW step; draws the
        revival rows of ``draws`` when they are missing."""
        if not self.use_vq_ema:
            return
        if self.revive_threshold > 0 and draws.revive_idx is None:
            n = z[..., 0].numel() * self.n_ranks
            draws.revive_idx = torch.randint(0, n, (self.codebook_size,),
                                             generator=state.generator, device=z.device)
        if self.revive_threshold > 0:
            z = global_rows(z.float(), self.group, self.accum)
        fold_codebook(state, self.model, new_ema, z, draws.revive_idx, self.revive_threshold)


def _own_rows(draws: Optional[Step3DDraws], group, accum: int) -> Step3DDraws:
    """The step's draws, a caller's global ε cut to this rank's rows."""
    draws = Step3DDraws() if draws is None else draws
    if group is not None and draws.eps is not None:
        draws.eps = rank_rows(draws.eps, group, accum)
    return draws


class _Microbatches:
    """A step's clip batch as ``accum`` microbatches and each one's draws:
    rows of the step's ε when it is given, else ε drawn a microbatch at a
    time and kept for both passes; ``gather()`` puts the whole batch's ε
    into the step's draws."""

    def __init__(self, batch: torch.Tensor, accum: int, draws: Step3DDraws):
        self.clips = microbatches(batch, accum)
        self.draws = draws
        mb = self.clips[0].shape[0]
        self.each = [Step3DDraws(eps=None if draws.eps is None
                                 else draws.eps[i * mb:(i + 1) * mb],
                                 frame_u=draws.frame_u)
                     for i in range(accum)]

    def gather(self) -> None:
        if self.draws.eps is None and self.each[0].eps is not None:
            self.draws.eps = torch.cat([d.eps for d in self.each])


def make_train_step_3d(
    cfg: TrainConfig, tvae_cfg: TVAEConfig, model: nn.Module, group=None,
) -> Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]:
    """The recon-only step (``trainer3d.py:49-163``): returns ``step(state,
    clips, draws=None) -> (state, metrics)`` with metrics ``recon_l2``,
    ``kl`` (the VQ loss for VQ) and ``loss``, 0-d device tensors. ``state``
    comes from ``create_train_state(..., recon_only=True)`` and is updated
    in place. ``group``: the data axis's process group (module docstring)."""
    _check(cfg, tvae_cfg)
    accum = max(1, cfg.grad_accum)
    latent = _Latent(tvae_cfg, model, group, accum)

    def loss(state, batch, vq_ema, draws):
        """One microbatch's (total, metrics, z, new EMA statistics)."""
        z = model.encode(batch)
        z_s, reg, new_ema = latent(z, state.generator, vq_ema, draws)
        recon = model.decode(z_s)
        rec = (recon.float() - batch).square().mean()
        total = rec + cfg.z_reg_weight * reg
        metrics = {"recon_l2": rec.detach(), "kl": reg.detach(), "loss": total.detach()}
        return total, metrics, z, new_ema

    def step(state: TrainState, clips: torch.Tensor, draws: Optional[Step3DDraws] = None):
        draws = _own_rows(draws, group, accum)
        mbs = _Microbatches(clips.float(), accum, draws)
        state.layout.begin_step(state)
        grads = GradMean(model.parameters(), accum)
        new_ema, outs, zs = state.vq_ema, [], []
        state.g_opt.zero_grad(set_to_none=True)
        for xb, d in zip(mbs.clips, mbs.each):
            total, m, z, ema = loss(state, xb, new_ema, d)
            backward_share(total, group)
            grads.take()
            outs.append(m)
            zs.append(z.detach())
            if latent.use_vq_ema:
                new_ema = ema
        grads.put()
        mbs.gather()
        metrics, z = mean_metrics(outs), torch.cat(zs)
        optimizer_step(state, state.g_opt, model, group)
        state.g_opt.zero_grad(set_to_none=True)
        latent.fold(state, new_ema, z, draws)
        state.layout.end_step(state)
        state.step += 1
        return state, global_metrics(metrics, group)

    return step


def make_train_step_3d_gan(
    cfg: TrainConfig,
    tvae_cfg: TVAEConfig,
    model: nn.Module,
    disc: Optional[nn.Module],
    lpips: nn.Module,
    gradnorm_shards: int = 1,
    group=None,
) -> Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]:
    """The full-GAN step (``step3d.py:66-331``): returns ``step(state, clips,
    draws=None) -> (state, metrics)``. ``disc`` is a ``PatchDiscriminator``
    (``cfg.disc_3d == "frame"``) or a ``TubeletDiscriminator`` built for the
    subset's frame count (``"tubelet"``); ``state`` comes from
    ``create_train_state`` and is updated in place. ``gradnorm_shards``: the
    data-parallel extent for ``cfg.gradnorm_mode = "mean_shard_norm"``;
    ``group``: the data axis's process group (module docstring)."""
    _check(cfg, tvae_cfg)
    if cfg.disc_3d not in ("frame", "tubelet"):
        raise ValueError(f"unknown disc_3d {cfg.disc_3d!r}")
    if cfg.do_ganloss and disc is None:
        raise ValueError("do_ganloss needs a discriminator")
    branch = gradnorm_branch(cfg, gradnorm_shards, group)
    accum = max(1, cfg.grad_accum)
    latent = _Latent(tvae_cfg, model, group, accum)
    tubelet = cfg.disc_3d == "tubelet"
    k = cfg.video_loss_frames
    # LPIPS and D as rematerialized regions with remat (JAX step3d.py:159-161)
    loss_policy = "full" if tvae_cfg.remat else None

    def disc_apply(x):
        return remat_call(disc, loss_policy, x)

    def lpips_apply(x, y):
        return remat_call(lpips, loss_policy, x, y)

    def disc_in(clip: torch.Tensor) -> torch.Tensor:
        """The frame disc takes a (B·T) frame batch, the tubelet disc the
        clip; both in fp32."""
        clip = clip.float()
        return clip if tubelet else flat_frames(clip)

    def g_losses(recon, reg_loss, batch, u):
        metrics = {}
        # LPIPS and the GAN branch see the frame subset, L2 every frame
        recon_f, target_f = frame_subset((recon, batch), k, u)
        recon_lpips = branch(recon_f, cfg.gradnorm_lpips)
        percep = lpips_apply(flat_frames(recon_lpips.float()),
                             flat_frames(target_f.float())).mean()
        metrics["perceptual_loss"] = percep
        recon_mse = branch(recon, cfg.gradnorm_mse)
        rec = (recon_mse.float() - batch).square().mean()
        metrics["recon_l2"] = rec
        metrics["kl"] = reg_loss
        total = percep + rec + cfg.z_reg_weight * reg_loss
        if cfg.do_ganloss:
            recon_gan = branch(recon_f, cfg.gradnorm_gan)
            g_gan = generator_gan_loss(disc_apply(disc_in(recon_gan)), cfg.disc_type)
            metrics["gan/generator_gan_loss"] = g_gan
            total = total + g_gan
        metrics["overall_vae_loss"] = total
        metrics["loss"] = total
        return total, metrics

    def step(state: TrainState, clips: torch.Tensor, draws: Optional[Step3DDraws] = None):
        draws = _own_rows(draws, group, accum)
        batch = clips.float()
        if draws.frame_u is None and 0 < k < batch.shape[1]:
            draws.frame_u = torch.rand((), generator=state.generator, device=batch.device)
        if accum > 1:
            return step_accum(state, batch, draws)
        state.layout.begin_step(state)

        # --- the one generator forward; its graph stays alive ---
        z = model.encode(batch)
        z_s, reg, new_ema = latent(z, state.generator, state.vq_ema, draws)
        recon = model.decode(z_s)
        metrics = {}

        # --- D's update before G, on the same frame subset ---
        if cfg.do_ganloss:
            recon_f, target_f = frame_subset((recon.detach().float(), batch), k, draws.frame_u)
            discriminator_update(cfg, disc_apply, state, [(disc_in(target_f), disc_in(recon_f))],
                                 1, metrics, group)

        # --- G against the updated D; D's params take no gradient ---
        with frozen(disc if cfg.do_ganloss else None):
            total, g_metrics = g_losses(recon, reg, batch, draws.frame_u)
        state.g_opt.zero_grad(set_to_none=True)
        backward_share(total, group)
        optimizer_step(state, state.g_opt, model, group)
        state.g_sched.step()
        state.g_opt.zero_grad(set_to_none=True)
        latent.fold(state, new_ema, z, draws)
        if cfg.ema_decay > 0:
            polyak_update(state, model, cfg.ema_decay)
        state.layout.end_step(state)
        state.step += 1
        metrics.update({name: v.detach() for name, v in g_metrics.items()})
        return state, global_metrics(metrics, group)

    def step_accum(state: TrainState, batch: torch.Tensor, draws: Step3DDraws):
        mbs = _Microbatches(batch, accum, draws)
        state.layout.begin_step(state)

        def d_pairs():
            """D's pass: each microbatch's generator without autograd or VQ
            statistics, on the step's frame subset."""
            for xb, d in zip(mbs.clips, mbs.each):
                with torch.no_grad():
                    z_s, _, _ = latent(model.encode(xb), state.generator, state.vq_ema, d,
                                       stats=False)
                    recon = model.decode(z_s)
                recon_f, target_f = frame_subset((recon.float(), xb), k, draws.frame_u)
                yield disc_in(target_f), disc_in(recon_f)

        metrics: dict[str, torch.Tensor] = {}
        if cfg.do_ganloss:
            discriminator_update(cfg, disc_apply, state, d_pairs(), accum, metrics, group)

        # --- G's pass against the updated D ---
        g_grads = GradMean(model.parameters(), accum)
        vq_ema, g_outs, zs = state.vq_ema, [], []
        state.g_opt.zero_grad(set_to_none=True)
        for xb, d in zip(mbs.clips, mbs.each):
            z = model.encode(xb)
            z_s, reg, new_ema = latent(z, state.generator, vq_ema, d)
            recon = model.decode(z_s)
            with frozen(disc if cfg.do_ganloss else None):
                total, g_m = g_losses(recon, reg, xb, draws.frame_u)
            backward_share(total, group)
            g_grads.take()
            g_outs.append(g_m)
            zs.append(z.detach())
            if latent.use_vq_ema:
                vq_ema = new_ema
        g_grads.put()
        mbs.gather()
        optimizer_step(state, state.g_opt, model, group)
        state.g_sched.step()
        state.g_opt.zero_grad(set_to_none=True)
        latent.fold(state, vq_ema, torch.cat(zs), draws)
        if cfg.ema_decay > 0:
            polyak_update(state, model, cfg.ema_decay)
        state.layout.end_step(state)
        state.step += 1
        metrics.update(mean_metrics(g_outs))
        return state, global_metrics(metrics, group)

    return step
