"""The GAN train step (counterpart of ``vqgan_tpu/train/step.py``,
``make_train_step``; reference vae_trainer.py:524-704).

One step at ``grad_accum <= 1``, in order:

  - input: a uint8 batch is normalized on the device; area-resize to the
    encoder's and the target's resolution; a random horizontal flip of both;
  - encoder; z statistics (quantiles, kurtosis, skewness) taken before the
    clamp; clamp; the regularizer: identity, the Gaussian sample mean +
    std·ε in the encoder's dtype (the z² penalty stays on the clamped
    encoder output, no KL; JAX step.py:138-145, 235-242), or the VQ latent
    (nearest code, straight-through z_q, ``vq_loss``, the batch's EMA
    statistics);
  - latent flip equivariance: flip z and the target along W and negate latent
    channels [-4, -2), then along H and negate [-2, C);
  - the crop bucket ``do_crop`` (static size, drawn offsets) of z and of the
    target;
  - decoder → recon. Its graph stays alive: the generator runs once forward
    and once backward per step;
  - discriminator update on ``recon.detach()`` and the fp32 target, with the
    LeCam anchors EMA'd first and the penalty taken against the new anchors;
  - generator losses against the UPDATED discriminator (reference :659, 684):
    GradNorm applied three separate times to recon (LPIPS w=1.0, MSE w=0.001,
    GAN w=1.0), LPIPS and D on ``recon.float()``, ``vae_loss_function``; D's
    params take no gradient from this backward;
  - one backward, G AdamW step, scheduler step;
  - VQ with EMA: the new EMA statistics folded into the codebook, then dead
    codes revived from the step's clamped, unflipped z
    (``vq_revive_threshold > 0``), then the statistics stored in the state;
  - the Polyak EMA of G's params when ``ema_decay > 0``, over the folded
    codebook too.

With ``grad_accum`` = k > 1 (JAX ``step_accum``, ``step.py:419-577``) the
batch is k microbatches and the step is one step at the whole batch, in two
passes over them:

  - D's pass: each microbatch's generator forward without autograd, then D's
    gradient on its detached recon; the LeCam anchors advance once a
    microbatch; the gradients are averaged as the JAX scan does (a + g/k, in
    microbatch order), then one D AdamW step;
  - G's pass against the updated D: each microbatch's generator forward and
    backward, the parameter gradients averaged the same way (not the loss:
    GradNorm's backward sets each branch's norm, so a scaled loss would keep
    1/k on the z² term alone), then one G AdamW step and one scheduler step;
  - VQ with EMA: the statistics run through G's pass from microbatch to
    microbatch (D's pass quantizes without them), revival samples the z of
    every microbatch; then the Polyak EMA;
  - metrics: the mean over the microbatches; the anchors their last values.

Its peak memory is one microbatch's graph. GradNorm normalizes each
microbatch's branch by that microbatch's own norm.

With ``vae_cfg.remat`` LPIPS and D are rematerialized regions too (JAX
``step.py:171-177``).

Randomness: the step's coins (input flip, latent flips, LPIPS augment flips),
crop offsets, dead-code revival rows and the Gaussian's ε are drawn from the state's
``torch.Generator`` on the device, and selected with ``torch.where`` so the host never waits for them. A
caller that needs given draws (the parity tests feed the JAX step's) passes
``draws``. Under accumulation one set of coins and crop offsets serves the
whole step, microbatch i takes rows [i·B/k, (i+1)·B/k) of ε in both passes,
and the revival rows index the z of the whole batch.

Data parallelism (``group``, the ``data`` axis's process group; JAX's
global-batch ``jit``, ``vqgan_tpu/parallel/mesh.py``): each of the N ranks
takes ``batch`` as its B rows of a global batch of N·B, and the step is the
one-process step on that global batch. Each rank's losses enter the
backward over N (its share of the global mean); G's and D's gradients are
summed across the ranks before their AdamW steps; GradNorm's norm is the
global batch's (``ops/gradnorm.py``; ``mean_shard_norm`` takes each rank's
rows as its shards); the LeCam anchors take the global mean logits; the VQ
counts and sums are summed across the ranks; the z statistics are taken on
the gathered z and every metric is the mean over the ranks. The draws are
the global batch's on every rank (the coins and offsets from the same
generator state; ε and the revival rows for N·B rows), and a rank takes its
own rows of ε. Under accumulation the global microbatch i is the ranks'
microbatches i in rank order, so the global batch is microbatch-major:
[mb 0 of rank 0, mb 0 of rank 1, ..., mb 1 of rank 0, ...].

The context axis (``context``, the process group of the ranks of one data
index, each holding a contiguous block of the same images' H rows; the VAE
built with it, ``VAE(cfg, context=group)``): the input resize is local
where its area factor fits a block, else taken on the gathered images; the
input flip and the latent W flip are local; the latent H flip is the
cross-rank reversal (``parallel/context.py::reverse_blocks``) of z_s and of
the target, and so is the LPIPS augment's H flip; the crop takes its window
of the whole latent and target and splits it again over the group
(``window_blocks``); a latent window whose rows do not split over the group
is decoded whole on every rank (``VAE.decode_whole``, the parameters'
gradients then each rank's rows' share) and each rank keeps its block of
the decoded rows, which must split. LPIPS and D run on the blocks or on the
gathered images (``losses/lpips.py``, ``losses/discriminator.py``). Every
loss of a rank's own rows (the z²
penalty, the VQ loss, D's means over its patches) is its local mean over
equal blocks, and LPIPS the whole images' on every rank of the group, so
the backward over ``group``'s N·C ranks and the gradient sum need nothing
new, as in the 3D step (``train/step3d.py``); GradNorm's norms take the
context ranks' squares together; the VQ statistics sum every rank's
tokens; the z statistics take the gathered tokens; ε and the revival rows
are the global latent's, a rank taking its rows and H block of ε. The HDR
recipe's options (accumulation, the heatmap loss, the wavelet front end,
the HR decoder) are not ported under it.

Sharded over the fsdp axis (``state.layout``, ``parallel/fsdp.py``) the step
starts by gathering G and D whole (``begin_step``), takes the same global
all_reduce of the gradients, then each rank keeps its block of each
parameter and gradient and AdamW steps on the blocks (``optimizer_step``);
D is gathered again for G's losses; the codebook fold runs on the whole
codebook; the Polyak EMA on the blocks; ``end_step`` leaves the blocks.
Accumulation keeps whole gradients over the microbatches and one reduction
a step.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterable, Optional

import torch
import torch.nn as nn

from vqgan_tpu_torch.config import DTYPES, TrainConfig, VAEConfig
from vqgan_tpu_torch.losses.gan import (
    gan_disc_loss,
    generator_gan_loss,
    lecam_penalty,
    update_lecam_anchors,
)
from vqgan_tpu_torch.losses.recon import vae_loss_function
from vqgan_tpu_torch.models.ae import CONTEXT_HDR
from vqgan_tpu_torch.models.blocks import remat_call
from vqgan_tpu_torch.models.quant import apply_ema_codebook_update, revive_dead_codes
from vqgan_tpu_torch.ops.gradnorm import gradnorm
from vqgan_tpu_torch.ops.resize import area_downsample, resize_area
from vqgan_tpu_torch.parallel.context import gather_blocks, reverse_blocks, window_blocks
from vqgan_tpu_torch.parallel.mesh import (
    gather_rows,
    group_rank,
    group_size,
    mean_across,
    reduce_gradients,
)
from vqgan_tpu_torch.train.state import TrainState

QUANTILES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


@dataclasses.dataclass
class StepDraws:
    """One step's random draws. Each coin is a bool or a 0-d bool tensor on
    the step's device (flip when true); each crop offset an int or a 0-d
    int64 tensor, in latent rows (``crop_h``) and columns (``crop_w``);
    ``revive_idx`` the (K,) int64 rows of the batch's flat z that dead codes
    take (VQ with ``vq_revive_threshold > 0`` only); ``eps`` the Gaussian
    latent's ε, (B, h, w, z_channels) in the encoder's dtype
    (``reg_type="gaussian"`` only)."""

    flip_in: Any
    flip_w: Any
    flip_h: Any
    crop_h: Any
    crop_w: Any
    aug_lpips_w: Any
    aug_lpips_h: Any
    revive_idx: Optional[torch.Tensor] = None
    eps: Optional[torch.Tensor] = None


def draw_step(generator: torch.Generator, crop_range: tuple[int, int],
              revive: Optional[tuple[int, int]] = None,
              eps: Optional[tuple[tuple[int, ...], torch.dtype]] = None) -> StepDraws:
    """Five fair coins and two crop offsets in [0, crop_range[i]], for
    ``revive = (K, N)`` K revival rows in [0, N), and for ``eps = (shape,
    dtype)`` a standard normal ε; on the generator's device (no host
    synchronisation)."""
    dev = generator.device
    coins = torch.rand(5, generator=generator, device=dev) < 0.5
    off_h, off_w = (torch.randint(0, n + 1, (), generator=generator, device=dev)
                    for n in crop_range)
    revive_idx = None
    if revive is not None:
        k, n = revive
        revive_idx = torch.randint(0, n, (k,), generator=generator, device=dev)
    noise = None
    if eps is not None:
        shape, dtype = eps
        noise = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
    return StepDraws(flip_in=coins[0], flip_w=coins[1], flip_h=coins[2],
                     crop_h=off_h, crop_w=off_w,
                     aug_lpips_w=coins[3], aug_lpips_h=coins[4], revive_idx=revive_idx,
                     eps=noise)


def _where(flag, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a if flag else b: a select on the device for a tensor flag."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag, a, b)
    return a if flag else b


def _flip(a: torch.Tensor, dim: int, context=None) -> torch.Tensor:
    """a flipped along ``dim``; along H (dim 1 of NHWC) under a ``context``
    group, the cross-rank reversal of the ranks' row blocks."""
    if context is not None and dim == 1:
        return reverse_blocks(a, 1, context)
    return a.flip(dim)


def _flip_if(flag, arrays, dim: int, context=None) -> tuple[torch.Tensor, ...]:
    return tuple(_where(flag, _flip(a, dim, context), a) for a in arrays)


def _latent_flip(flag, z_s, target, dim: int, neg_lo: int, neg_hi: int, context=None):
    """Flip z_s and the target along one spatial dim and negate latent
    channels [neg_lo, neg_hi) (the sign channels of the Z2×Z2-equivariant
    latent; vae_trainer.py:567-575); along H under ``context``, across the
    ranks."""
    c = z_s.shape[-1]
    lo = c + neg_lo if neg_lo < 0 else neg_lo
    hi = c + neg_hi if neg_hi < 0 else neg_hi
    idx = torch.arange(c, device=z_s.device)
    sign = torch.where((idx >= lo) & (idx < hi), -1.0, 1.0).to(z_s.dtype)
    z_new = _where(flag, _flip(z_s, dim, context) * sign, z_s)
    t_new = _where(flag, _flip(target, dim, context), target)
    return z_new, t_new


def _crop(x: torch.Tensor, off_h, off_w, h: int, w: int, context=None,
          whole: bool = False) -> torch.Tensor:
    """x[:, off_h:off_h+h, off_w:off_w+w] of NHWC, for int or tensor offsets;
    under ``context`` (x this rank's block of rows) this rank's block of the
    window's rows (``window_blocks``), or with ``whole`` the whole window on
    every rank."""
    cols = torch.arange(w, device=x.device) + off_w
    if context is not None and not whole:
        return window_blocks(x, 1, off_h, h, context).index_select(2, cols)
    rows = torch.arange(h, device=x.device) + off_h
    return gather_blocks(x, 1, context).index_select(1, rows).index_select(2, cols)


def _own_rows(x: torch.Tensor, context) -> torch.Tensor:
    """This rank's block of the rows of NHWC x, which every rank of
    ``context`` holds whole."""
    n, me = group_size(context), group_rank(context)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} rows do not split over {n} context ranks")
    h = x.shape[1] // n
    return x[:, me * h:(me + 1) * h]


def _resize_rows(x: torch.Tensor, size: int, context=None) -> torch.Tensor:
    """``resize_area`` of NHWC images to (size, size); under ``context`` x
    is this rank's block of rows and so is the result: an integer area
    factor that fits the block runs on it, any other resize on the gathered
    images, this rank's rows of it kept."""
    if context is None:
        return resize_area(x, (size, size))
    n, h, w = group_size(context), x.shape[1], x.shape[2]
    if h * n == size and w == size:
        return x
    f = w // size
    if w == f * size and h % f == 0 and (h * n) // f == size:
        return area_downsample(x, f)
    return _own_rows(resize_area(gather_blocks(x, 1, context), (size, size)), context)


def z_statistics(z: torch.Tensor) -> dict[str, torch.Tensor]:
    """Quantiles {0, .2, ..., 1}, kurtosis and skewness of z
    (vae_trainer.py:540-559)."""
    zf = z.float().reshape(-1)
    # torch.quantile interpolates linearly, as jnp.quantile does; it refuses
    # inputs above 2^24 elements (the flagship z at batch 8 has 131,072)
    qs = torch.quantile(zf, torch.tensor(QUANTILES, device=zf.device))
    mean = zf.mean()
    std = zf.std(correction=0)  # population std, as jnp.std
    centered = zf - mean
    out = {f"z_quantiles/{q:.1f}": qs[i] for i, q in enumerate(QUANTILES)}
    out["z_quantiles/kurtosis"] = centered.pow(4).mean() / (std.pow(4) + 1e-12)
    out["z_quantiles/skewness"] = centered.pow(3).mean() / (std.pow(3) + 1e-12)
    return out


def discriminator_loss(cfg: TrainConfig, disc: Callable, anchors: tuple,
                       real: torch.Tensor, fake: torch.Tensor, group=None):
    """D's loss on the real and the (detached) fake inputs: the GAN loss, the
    LeCam anchors EMA'd from the logits first and the penalty taken against
    the new anchors (reference :639-655). Returns ``(total, metrics, new
    anchors)``. Under ``group`` the anchors take the global batch's mean
    logits."""
    real_preds = disc(real)
    fake_preds = disc(fake)
    d_loss, d_metrics = gan_disc_loss(real_preds, fake_preds, cfg.disc_type)
    if group is not None:
        avg = mean_across(torch.stack([d_metrics["avg_real_logits"].detach(),
                                       d_metrics["avg_fake_logits"].detach()]), group)
        d_metrics["avg_real_logits"], d_metrics["avg_fake_logits"] = avg[0], avg[1]
    new_real, new_fake = update_lecam_anchors(
        anchors[0], anchors[1],
        d_metrics["avg_real_logits"].detach(),
        d_metrics["avg_fake_logits"].detach(),
        cfg.lecam_beta,
    )
    total_d = d_loss
    lecam_val = torch.zeros((), device=d_loss.device)
    if cfg.use_lecam:
        lecam_val = lecam_penalty(real_preds, fake_preds, new_real, new_fake)
        total_d = total_d + cfg.lecam_weight * lecam_val
    metrics = {
        "gan/discriminator_loss": d_loss.detach(),
        "gan/discriminator_accuracy": d_metrics["disc_acc"],
        "gan/avg_real_logits": d_metrics["avg_real_logits"].detach(),
        "gan/avg_fake_logits": d_metrics["avg_fake_logits"].detach(),
        "gan/lecam_loss": lecam_val.detach(),
    }
    return total_d, metrics, (new_real, new_fake)


def discriminator_update(cfg: TrainConfig, disc: Callable, state: TrainState,
                         pairs: Iterable[tuple[torch.Tensor, torch.Tensor]], accum: int,
                         metrics: dict[str, torch.Tensor], group=None) -> None:
    """One AdamW step of D (``state.d_model``, called through ``disc``) on
    the mean of its gradients over ``pairs``, each microbatch's (real,
    detached fake) inputs (one pair without accumulation), taken a pair at a
    time: ``discriminator_loss``, the LeCam anchors advancing a pair at a
    time (JAX's D scan). The mean of D's metrics and the last anchors go to
    ``metrics``. Under ``group`` each rank's loss enters the backward over
    the ranks' count and the gradients are summed across them; under fsdp
    D steps on this rank's blocks and is gathered whole again."""
    grads = GradMean(state.d_model.parameters(), accum)
    anchors = (state.lecam_real, state.lecam_fake)
    outs = []
    state.d_opt.zero_grad(set_to_none=True)
    for real, fake in pairs:
        total_d, d_metrics, anchors = discriminator_loss(cfg, disc, anchors, real, fake, group)
        backward_share(total_d, group)
        grads.take()
        outs.append(d_metrics)
    grads.put()
    optimizer_step(state, state.d_opt, state.d_model, group)
    state.d_opt.zero_grad(set_to_none=True)
    state.layout.gather_(state.d_model)  # G's losses run through the updated D
    state.lecam_real, state.lecam_fake = anchors
    metrics.update(mean_metrics(outs))
    metrics["gan/lecam_anchor_real_logits"] = anchors[0]
    metrics["gan/lecam_anchor_fake_logits"] = anchors[1]


def optimizer_step(state: TrainState, opt: torch.optim.Optimizer, model: nn.Module,
                   group) -> None:
    """``opt``'s step on ``model``'s gradients summed across ``group``;
    under fsdp on this rank's blocks of the parameters and gradients (the
    all_reduce, then each rank keeps its block)."""
    reduce_gradients(model.parameters(), group)
    state.layout.shard_(model)
    opt.step()


def microbatches(batch: torch.Tensor, accum: int) -> list[torch.Tensor]:
    """``batch`` split along dim 0 into ``accum`` equal microbatches (views)."""
    b = batch.shape[0]
    if b % accum:
        raise ValueError(f"batch {b} not divisible by grad_accum {accum}")
    return list(batch.split(b // accum))


def backward_share(loss: torch.Tensor, group) -> None:
    """``loss.backward()``; under ``group`` of N ranks the backward of
    loss / N, this rank's share of the global batch's mean (the ranks'
    gradients are then summed)."""
    if group is None:
        loss.backward()
    else:
        (loss * (1.0 / group_size(group))).backward()


def global_rows(local: torch.Tensor, group, accum: int = 1, context=None) -> torch.Tensor:
    """The global batch's rows of a per-rank tensor whose dim 0 is this
    rank's batch (``accum`` microbatches of it): gathered across ``group``
    (4- or 8-byte elements), microbatch-major as the step orders the global
    batch. With a ``context`` group (ranks of one data index hold blocks of
    dim 1, T or H, of the same clips or images) each data index's blocks are
    joined in order."""
    if group is None:
        return local
    n_ctx = group_size(context)
    n, b, t = group_size(group) // n_ctx, local.shape[0], local.shape[1]
    rest = tuple(local.shape[2:])
    rows = gather_rows(local, group).reshape((n, n_ctx, b, t) + rest).transpose(1, 2)
    rows = rows.reshape((n, accum, b // accum, n_ctx * t) + rest).transpose(0, 1)
    return rows.reshape((n * b, n_ctx * t) + rest)


def rank_rows(global_t: torch.Tensor, group, accum: int = 1, context=None) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (``global_rows``' inverse),
    and with a ``context`` group its block of dim 1 (T or H) of them."""
    if group is None:
        return global_t
    n_ctx = group_size(context)
    n, index = group_size(group) // n_ctx, group_rank(group) // n_ctx
    b = global_t.shape[0] // n
    rest = tuple(global_t.shape[1:])
    rows = global_t.reshape((accum, n, b // accum) + rest)[:, index].reshape((b,) + rest)
    if context is None:
        return rows
    t, i = rows.shape[1] // n_ctx, group_rank(context)
    return rows[:, i * t:(i + 1) * t]


def global_metrics(metrics: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Each metric's mean over the ranks, in one all_reduce."""
    if group is None or not metrics:
        return metrics
    names = list(metrics)
    means = mean_across(torch.stack([metrics[k].detach().float() for k in names]), group)
    return dict(zip(names, means.unbind()))


def z_metrics(z_pre: torch.Tensor, z: torch.Tensor, group) -> dict[str, torch.Tensor]:
    """``z_statistics`` of the pre-clamp z, over the ranks' gathered rows
    under ``group``, with the clamped z's ``std_of_abs_z`` taken the same
    way (the other z metrics are means)."""
    if group is None:
        return z_statistics(z_pre)
    out = z_statistics(gather_rows(z_pre.float(), group))
    out["std_of_abs_z"] = gather_rows(z.detach().float(), group).abs().std(correction=0)
    return out


class GradMean:
    """The mean of the parameters' gradients over ``accum`` backwards, summed
    as the JAX scan sums them: acc ← acc + g/accum in call order, so that a
    power-of-two ``accum`` gives the full-batch mean's rounding. ``take()``
    after each backward moves the ``.grad`` tensors in and clears them;
    ``put()`` sets each ``.grad`` to its mean (None where no backward
    reached it)."""

    def __init__(self, params, accum: int):
        self.params = list(params)
        self.accum = accum
        self.sums: list[Optional[torch.Tensor]] = [None] * len(self.params)

    def take(self) -> None:
        have = [(i, p.grad) for i, p in enumerate(self.params) if p.grad is not None]
        if not have:
            return
        torch._foreach_div_([g for _, g in have], float(self.accum))
        old = [(self.sums[i], g) for i, g in have if self.sums[i] is not None]
        if old:
            torch._foreach_add_([a for a, _ in old], [g for _, g in old])
        for i, g in have:
            if self.sums[i] is None:
                self.sums[i] = g
        for p in self.params:
            p.grad = None

    def put(self) -> None:
        for p, g in zip(self.params, self.sums):
            p.grad = g
        self.sums = [None] * len(self.params)


def mean_metrics(outs: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Each metric's mean over the microbatches' dicts."""
    return {k: torch.stack([o[k].detach().float() for o in outs]).mean() for k in outs[0]}


@contextlib.contextmanager
def frozen(module: Optional[nn.Module]):
    """``module``'s params take no gradient inside the block (G's backward
    through the updated D)."""
    params = [] if module is None else list(module.parameters())
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@torch.no_grad()
def fold_codebook(state: TrainState, model: nn.Module, new_ema: dict[str, torch.Tensor],
                  z: torch.Tensor, revive_idx: Optional[torch.Tensor],
                  revive_threshold: float) -> None:
    """After G's AdamW step: the EMA statistics folded into ``model.reg``'s
    codebook in place (overwriting whatever AdamW did; in EMA mode the
    codebook takes no gradient), then, for ``revive_threshold`` > 0, dead
    codes revived from the rows ``revive_idx`` of the flat z; the statistics
    stored in the state (JAX step.py:364-388). Under fsdp the fold and the
    revival run on the whole statistics and codebook, the same on every
    rank, and the state keeps this rank's blocks."""
    codebook = model.reg.codebook
    new_cb = apply_ema_codebook_update(codebook, new_ema["counts"], new_ema["sums"],
                                       model.reg.ema_eps)
    if revive_threshold > 0:
        flat_z = z.detach().float().reshape(-1, z.shape[-1])
        new_cb = revive_dead_codes(new_cb, new_ema["counts"], flat_z, revive_idx,
                                   revive_threshold)
    state.layout.assign_(codebook, new_cb)
    state.vq_ema = state.layout.shard_vq(new_ema)


@torch.no_grad()
def polyak_update(state: TrainState, model: nn.Module, decay: float) -> None:
    """state.g_ema ← decay·g_ema + (1 − decay)·params, by name (under fsdp
    on this rank's blocks of both, after G's sharded AdamW step)."""
    names = list(state.g_ema)
    params = dict(model.named_parameters())
    ema = [state.g_ema[n] for n in names]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[n] for n in names], alpha=1.0 - decay)


def gradnorm_branch(cfg: TrainConfig, gradnorm_shards: int, group, context=None) -> Callable:
    """``(x, weight) -> gradnorm(x, ...)`` for the step's mode: the global
    Frobenius norm, or with ``cfg.gradnorm_mode = "mean_shard_norm"`` the
    mean of ``gradnorm_shards`` block norms (1: the global norm again). Under
    ``group`` the norm is the global batch's: the blocks are split evenly
    over the data ranks (JAX's ``gradnorm_shards = n_data``: one a data
    index), each block's frames over the ``context`` group's ranks."""
    gn_shards = gradnorm_shards if cfg.gradnorm_mode == "mean_shard_norm" else 1
    if group is None:
        return lambda x, w: gradnorm(x, w, None, gn_shards)
    if gn_shards == 1:
        return lambda x, w: gradnorm(x, w, group, 1, global_norm=True)
    n = group_size(group) // group_size(context)
    if gn_shards % n:
        raise ValueError(f"gradnorm_shards {gn_shards} must divide by the {n} data ranks")
    return lambda x, w: gradnorm(x, w, group, gn_shards // n, context=context)


def make_train_step(
    cfg: TrainConfig,
    vae_cfg: VAEConfig,
    vae: nn.Module,
    disc: Optional[nn.Module],
    lpips: nn.Module,
    gradnorm_shards: int = 1,
    group=None,
    context=None,
) -> Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]:
    """Returns ``step(state, batch, do_crop=0, draws=None) -> (state,
    metrics)``. ``state`` is a ``TrainState`` of these models and is updated
    in place; ``batch`` is (B, S, S, 3), uint8 or float in [-1, 1], on the
    models' device; ``do_crop`` is 0 (no crop) or a 1-based bucket of
    ``cfg.crop_fractions``; metrics are 0-d device tensors.

    ``gradnorm_shards``: the data-parallel extent for
    ``cfg.gradnorm_mode = "mean_shard_norm"``; 1 = global-norm mode.
    ``group``: every rank's process group (see the module docstring);
    ``batch`` is then this rank's rows, ``draws.eps`` the global batch's.
    ``context``: the ranks that split this rank's images' rows, with which
    ``vae`` was built (module docstring); ``batch`` is then this rank's
    block of rows of its rows."""
    if cfg.gradnorm_mode not in ("global", "mean_shard_norm"):
        raise ValueError(f"unknown gradnorm_mode {cfg.gradnorm_mode!r}")
    if cfg.do_ganloss and disc is None:
        raise ValueError("do_ganloss needs a discriminator")
    if context is not None and (cfg.grad_accum > 1 or not cfg.do_pool_recon
                                and cfg.recon_weight != 0.0):
        raise NotImplementedError(
            f"grad_accum={cfg.grad_accum}, the heatmap recon loss (do_pool_recon="
            f"{cfg.do_pool_recon}, recon_weight={cfg.recon_weight}) over H blocks of the "
            f"context axis: not ported yet ({CONTEXT_HDR})")
    branch = gradnorm_branch(cfg, gradnorm_shards, group, context)
    n_ranks = group_size(group)
    n_data = n_ranks // group_size(context)
    accum = max(1, cfg.grad_accum)

    enc_res = vae_cfg.resolution
    hr = vae_cfg.decoder_also_perform_hr
    tgt_res = enc_res * (2 if hr else 1)
    ds_factor = cfg.downscale_factor * (2 if hr else 1)
    z_side = enc_res // vae_cfg.ffactor
    use_vq = vae_cfg.reg_type == "vq"
    sampled = vae_cfg.reg_type == "gaussian"
    enc_dtype = DTYPES[vae_cfg.enc_dtype]
    use_vq_ema = use_vq and vae_cfg.vq_ema_decay > 0
    revive = use_vq_ema and vae_cfg.vq_revive_threshold > 0

    def crop_size(do_crop: int) -> tuple[int, int]:
        if int(do_crop) > len(cfg.crop_fractions):
            raise ValueError(f"crop bucket {int(do_crop)} out of range for "
                             f"crop_fractions {cfg.crop_fractions}")
        frac = cfg.crop_fractions[int(do_crop) - 1]
        side = max(1, int(round(frac * z_side)))
        return side, side

    # LPIPS and D as rematerialized regions with remat (JAX step.py:171-177)
    loss_policy = "full" if vae_cfg.remat else None

    # under context LPIPS and D take the group (losses/lpips.py)
    over = () if context is None else (context,)

    def disc_apply(x):
        return remat_call(disc, loss_policy, x, *over)

    def lpips_apply(x, y):
        return remat_call(lpips, loss_policy, x, y, *over)

    def gen_forward(batch, draws, do_crop, vq_ema, stats: bool = True):
        """→ (recon, z, target, z_pre, aux_loss, new_ema). ``stats=False``
        (D's pass under accumulation): VQ quantizes without its loss and
        statistics."""
        if batch.dtype == torch.uint8:
            batch = batch.float() / 127.5 - 1.0
        x_enc = _resize_rows(batch, enc_res, context)
        target = _resize_rows(batch, tgt_res, context)
        x_enc, target = _flip_if(draws.flip_in, (x_enc, target), 2)

        z = vae.encode(x_enc)
        z_pre = z.detach()  # statistics are taken before the clamp
        if cfg.do_clamp:
            z = z.clamp(-cfg.clamp_th, cfg.clamp_th)
        aux_loss = new_ema = None
        if use_vq and not stats:
            z_s = vae.reg.quantize(z)
        elif use_vq:
            z_s, aux, new_ema = vae.regularize(z, vq_ema, update_stats=use_vq_ema, group=group)
            aux_loss = aux["vq_loss"]
        else:
            z_s = vae.regularize(z, eps=draws.eps)
        if cfg.flip_invariance:
            c = z_s.shape[-1]
            z_s, target = _latent_flip(draws.flip_w, z_s, target, 2, -4, -2)
            z_s, target = _latent_flip(draws.flip_h, z_s, target, 1, -2, c, context)
        whole = False
        if do_crop:
            ch, cw = crop_size(do_crop)
            whole = context is not None and ch % group_size(context) != 0
            z_s = _crop(z_s, draws.crop_h, draws.crop_w, ch, cw, context, whole)
            target = _crop(target, draws.crop_h * ds_factor, draws.crop_w * ds_factor,
                           ch * ds_factor, cw * ds_factor, context)
        recon = _own_rows(vae.decode_whole(z_s), context) if whole else vae.decode(z_s)
        return recon, z, target, z_pre, aux_loss, new_ema

    def g_losses(recon, z, aux_loss, target, draws):
        """All generator loss branches (reference vae_trainer.py:662-698)."""
        metrics = {}
        recon_lpips = branch(recon, cfg.gradnorm_lpips)
        target_aug = target
        if cfg.augment_before_perceptual_loss:
            recon_lpips, target_aug = _flip_if(draws.aug_lpips_w, (recon_lpips, target_aug), 2)
            recon_lpips, target_aug = _flip_if(draws.aug_lpips_h, (recon_lpips, target_aug), 1,
                                               context)
        percep = lpips_apply(recon_lpips.float(), target_aug).mean()
        metrics["perceptual_loss"] = percep

        recon_mse = branch(recon, cfg.gradnorm_mse)
        vae_loss, vae_metrics = vae_loss_function(
            target, recon_mse.float(), z, do_pool=cfg.do_pool_recon,
            recon_weight=cfg.recon_weight, z_reg_weight=cfg.z_reg_weight,
        )
        metrics.update(vae_metrics)

        total = percep + vae_loss
        if aux_loss is not None:
            total = total + aux_loss
        if cfg.do_ganloss:
            recon_gan = branch(recon, cfg.gradnorm_gan)
            g_gan = generator_gan_loss(disc_apply(recon_gan.float()), cfg.disc_type)
            metrics["gan/generator_gan_loss"] = g_gan
            total = total + g_gan
        metrics["overall_vae_loss"] = total
        if aux_loss is not None:
            metrics["vq_loss"] = aux_loss
        return total, metrics

    def step_draws(state: TrainState, batch: torch.Tensor, do_crop: int,
                   draws: Optional[StepDraws]) -> StepDraws:
        """The global batch's draws; ε cut to this rank's rows (and its
        block of them under ``context``)."""
        rows = batch.shape[0] * n_data
        if draws is None:
            crop_range = (0, 0)
            if do_crop:
                ch, cw = crop_size(do_crop)
                crop_range = (z_side - ch, z_side - cw)
            n_tokens = rows * z_side * z_side
            eps = ((rows, z_side, z_side, vae_cfg.z_channels), enc_dtype)
            draws = draw_step(state.generator, crop_range,
                              (vae_cfg.vq_codebook_size, n_tokens) if revive else None,
                              eps if sampled else None)
        elif revive and draws.revive_idx is None:
            raise ValueError("vq_revive_threshold > 0: draws.revive_idx is needed")
        elif sampled and draws.eps is None:
            raise ValueError("reg_type='gaussian': draws.eps is needed")
        if group is not None and draws.eps is not None:
            if draws.eps.shape[0] != rows:
                raise ValueError(f"draws.eps has {draws.eps.shape[0]} rows; the global batch "
                                 f"{rows}")
            draws = dataclasses.replace(draws, eps=rank_rows(draws.eps, group, accum, context))
        return draws

    def step(state: TrainState, batch: torch.Tensor, do_crop: int = 0,
             draws: Optional[StepDraws] = None):
        draws = step_draws(state, batch, do_crop, draws)
        state.layout.begin_step(state)

        # --- shared generator forward (one forward, one backward per step) ---
        recon, z, target, z_pre, aux_loss, new_ema = gen_forward(batch, draws, do_crop,
                                                                 state.vq_ema)
        z_m = z_metrics(z_pre, z, group)
        metrics = dict(z_m)

        # --- discriminator update, before G ---
        if cfg.do_ganloss:
            discriminator_update(cfg, disc_apply, state, [(target, recon.detach().float())],
                                 1, metrics, group)

        # --- generator update against the updated D; D's params take no
        # gradient from this backward ---
        with frozen(disc if cfg.do_ganloss else None):
            total, g_metrics = g_losses(recon, z, aux_loss, target, draws)
        state.g_opt.zero_grad(set_to_none=True)
        backward_share(total, group)
        optimizer_step(state, state.g_opt, vae, group)
        state.g_sched.step()
        state.g_opt.zero_grad(set_to_none=True)
        if use_vq_ema:
            # revival from the clamped, unflipped z (the global batch's)
            fold_codebook(state, vae, new_ema, global_rows(z.detach().float(), group,
                                                            context=context),
                          draws.revive_idx, vae_cfg.vq_revive_threshold)

        if cfg.ema_decay > 0:
            polyak_update(state, vae, cfg.ema_decay)
        state.layout.end_step(state)
        state.step += 1
        metrics.update({k: v.detach() for k, v in g_metrics.items()})
        metrics.update(z_m)  # under a group: the gathered z's std_of_abs_z
        return state, global_metrics(metrics, group)

    if accum == 1:
        return step

    def step_accum(state: TrainState, batch: torch.Tensor, do_crop: int = 0,
                   draws: Optional[StepDraws] = None):
        mbs = microbatches(batch, accum)
        draws = step_draws(state, batch, do_crop, draws)
        state.layout.begin_step(state)
        mb = mbs[0].shape[0]

        def mb_draws(i: int) -> StepDraws:
            if draws.eps is None:
                return draws
            return dataclasses.replace(draws, eps=draws.eps[i * mb:(i + 1) * mb])

        def d_pairs():
            """D's pass: each microbatch's generator without autograd."""
            for i, xb in enumerate(mbs):
                with torch.no_grad():
                    recon, _, target, _, _, _ = gen_forward(xb, mb_draws(i), do_crop,
                                                            state.vq_ema, stats=False)
                yield target, recon.float()

        metrics: dict[str, torch.Tensor] = {}
        if cfg.do_ganloss:
            discriminator_update(cfg, disc_apply, state, d_pairs(), accum, metrics, group)

        # --- G's pass against the updated D: forward and backward a
        # microbatch, the mean gradient ---
        g_grads = GradMean(vae.parameters(), accum)
        vq_ema = state.vq_ema
        g_outs, z_all = [], []
        state.g_opt.zero_grad(set_to_none=True)
        for i, xb in enumerate(mbs):
            recon, z, target, z_pre, aux_loss, new_ema = gen_forward(xb, mb_draws(i), do_crop,
                                                                     vq_ema)
            with frozen(disc if cfg.do_ganloss else None):
                total, g_m = g_losses(recon, z, aux_loss, target, mb_draws(i))
            backward_share(total, group)
            g_grads.take()
            g_m.update(z_metrics(z_pre, z, group))
            g_outs.append(g_m)
            z_all.append(z.detach())
            if use_vq_ema:
                vq_ema = new_ema
        g_grads.put()
        optimizer_step(state, state.g_opt, vae, group)
        state.g_sched.step()
        state.g_opt.zero_grad(set_to_none=True)
        if use_vq_ema:
            fold_codebook(state, vae, vq_ema, global_rows(torch.cat(z_all).float(), group, accum),
                          draws.revive_idx, vae_cfg.vq_revive_threshold)
        if cfg.ema_decay > 0:
            polyak_update(state, vae, cfg.ema_decay)
        state.layout.end_step(state)
        state.step += 1
        metrics.update(mean_metrics(g_outs))
        return state, global_metrics(metrics, group)

    return step_accum
