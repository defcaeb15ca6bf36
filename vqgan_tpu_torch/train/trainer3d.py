"""Training orchestration for the 3D video VAE (TVAE) (counterpart of
``vqgan_tpu/train/trainer3d.py``).

``Trainer3D(cfg, tvae_cfg, frames, device="cuda").train()`` runs the JAX
trainer's job: the recon-only step (L2 + ``z_reg_weight``·KL, or the VQ loss
with the EMA codebook fold and dead-code revival; one constant-lr AdamW), or
with ``do_ganloss`` the full per-frame GAN step (fp32 LPIPS and a fp32
``PatchDiscriminator``, or the ``TubeletDiscriminator``; GradNorm branches,
LeCam, the Polyak EMA), both from ``train/step3d.py``. Clips come from tar
shards of ``.npy``/``.npz`` samples (``data/video.py``) or from
``synthetic_video_batches``, each stream seeded ``seed + start_step``, so a
resume continues on a fresh but reproducible order (as in JAX, not
sample-exact). The eval batch is fixed once per run. Every
``evaluate_every_n_steps`` (``(step + 1) % n == 1``) the NaN guard, the eval
and a full-state checkpoint; at the end the same at ``max_steps``.

``grad_accum > 1`` splits each batch into microbatches
(``train/step3d.py``); ``remat`` makes the model's levels and blocks
rematerialized regions. Under ``torchrun --nproc_per_node N`` the ``data``
axis splits the global ``batch_size`` over N ranks as the 2D ``Trainer``
does (``train/trainer.py``): a rank a process, rank 0's weights broadcast,
the states checked equal, rank 0 alone evaluating, logging and saving, each
rank reading its share of the clips (its shards, or the same synthetic
clips on every rank, as in JAX). ``data=D,fsdp=F`` splits the batch over
D·F ranks and shards the train state over F of them (``parallel/fsdp.py``),
every rank taking part in the gathers before eval and saves.
``data=D,context=C`` splits each clip's T frames over the C ranks of a
data index (JAX ``_ctx_feed``): those ranks read the same clips (the stream
split by data index) and each keeps its contiguous T block; the model runs
with the context group (``TVAE(cfg, context=...)``: T halos, two-pass
GroupNorms, ring attention) and the step takes the global means over it
(``train/step3d.py``). Rank 0 evaluates the same parameters on whole clips
with no group: the ring is exact, so these are the numbers JAX's eval
gives, with no collective for the other ranks to wait on. Checkpoints stay
the whole tree and load at any layout. Not ported: the ``tensor`` axis and
``fsdp`` together with ``context``, which raise NotImplementedError naming
their ROADMAP.md Queue 1 items.

One deliberate difference from the JAX trainer: ``load_path`` loads G before
the train state is built, so the Polyak EMA and the VQ EMA statistics start
from the loaded weights (JAX keeps them at the random init's).

Models are built on an explicit device, ``"cuda"`` unless the caller asks
for ``"cpu"``; there is no fallback from one to the other.
"""

from __future__ import annotations

import os
import traceback
from typing import Iterator, Optional

import numpy as np
import torch

from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
from vqgan_tpu_torch.data.loader import device_prefetch, to_device
from vqgan_tpu_torch.data.video import create_video_dataloader
from vqgan_tpu_torch.losses.discriminator import (
    PatchDiscriminator,
    TubeletDiscriminator,
    init_discriminator_,
)
from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
from vqgan_tpu_torch.losses.metrics import psnr, ssim
from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.models.tae import TVAE, check_context_frames, init_weights_
from vqgan_tpu_torch.parallel.fsdp import shard_state
from vqgan_tpu_torch.train.checkpoint import CheckpointManager, state_dict_of
from vqgan_tpu_torch.train.state import create_train_state, to_channels_last
from vqgan_tpu_torch.train.step3d import flat_frames, make_train_step_3d, make_train_step_3d_gan
from vqgan_tpu_torch.train.trainer import (
    DivergenceError,
    _host_metrics,
    check_replicas,
    data_parallel,
    eval_params,
    replicate,
)
from vqgan_tpu_torch.utils.logging import MetricLogger
from vqgan_tpu_torch.weights import load_lpips_weights, load_weights

# the fixed synthetic eval stream's seed offset (JAX trainer3d.py's)
EVAL_SEED_OFFSET = 999_983


def synthetic_video_batches(batch: int, frames: int, size: int,
                            seed: int = 0) -> Iterator[np.ndarray]:
    """Deterministic moving-gradient clips (B, T, H, W, 3) in [-1, 1], fp32:
    the JAX package's generator (``trainer3d.py:27-45``), draw for draw."""
    step = 0
    while True:
        rng = np.random.default_rng(seed * 7919 + step)
        t = np.arange(frames, dtype=np.float32)[None, :, None, None, None]
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        clips = []
        for _ in range(batch):
            vx, vy, ph = rng.uniform(-1, 1, 3).astype(np.float32)
            base = np.sin(
                2 * np.pi * (xx[None] * 2 + yy[None] * 3 + ph)
                + 0.3 * t[0, :, :, 0] * vx
            )
            clip = np.stack([base * c for c in rng.uniform(0.3, 1.0, 3)], -1)
            clips.append(np.clip(clip, -1, 1))
        yield np.stack(clips).astype(np.float32)
        step += 1


class Trainer3D:
    """``Trainer3D(cfg, tvae_cfg, frames, device="cuda").train()``."""

    def __init__(self, cfg: TrainConfig, tvae_cfg: TVAEConfig, frames: int = 8,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.tvae_cfg = tvae_cfg
        self.frames = frames
        self.device, self.mesh = data_parallel(cfg, device, context=True)
        self.is_master = self.mesh.is_master
        self.local_batch = cfg.batch_size // self.mesh.n_data
        group, context = self.mesh.group, self.mesh.context_group
        if self.mesh.n_context > 1:
            check_context_frames(frames, tvae_cfg.ch_mult, self.mesh.n_context)
        self.use_gan = cfg.do_ganloss

        # one generator for each of G, D, LPIPS and the step's draws, from
        # cfg.seed
        s_g, s_d, s_lpips, s_state = (int(s) for s in
                                      np.random.SeedSequence(cfg.seed).generate_state(4))
        dev = self.device

        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=dev).manual_seed(seed)

        with torch.device(dev):
            self.model = TVAE(tvae_cfg, context=context)
        init_weights_(self.model, gen(s_g))
        if cfg.load_path:  # G only
            self.model.load_state_dict(load_weights(cfg.load_path), strict=True)
        reg = self.model.reg
        # the JAX init's statistics: counts 1, sums the codebook
        vq_ema = reg.init_ema() if isinstance(reg, VectorQuantizer) and reg.ema_decay > 0 \
            else None

        self.disc = self.lpips = None
        if self.use_gan:
            # the JAX 3D trainer runs D and LPIPS in fp32
            k = cfg.video_loss_frames if cfg.video_loss_frames > 0 else frames
            with torch.device(dev):
                self.disc = (TubeletDiscriminator(min(k, frames)) if cfg.disc_3d == "tubelet"
                             else PatchDiscriminator())
                self.lpips = LPIPS()
            init_discriminator_(self.disc, gen(s_d))
            init_lpips_(self.lpips, gen(s_lpips))
            if cfg.lpips_weights:
                self.lpips.load_state_dict(load_lpips_weights(cfg.lpips_weights), strict=True)
        # every rank starts from rank 0's weights
        replicate(self.mesh, (self.model, self.disc, self.lpips),
                  vq_ema.values() if vq_ema is not None else ())
        if self.use_gan:
            self.state = create_train_state(cfg, self.model, self.disc, tvae_cfg.ch,
                                            seed=s_state, vq_ema=vq_ema)
            shard_state(self.state, self.mesh)
            self._step = make_train_step_3d_gan(cfg, tvae_cfg, self.model, self.disc,
                                                self.lpips, gradnorm_shards=self.mesh.n_data,
                                                group=group, context=context)
        else:
            # one AdamW at the constant lr learning_rate_vae / ch
            self.state = create_train_state(cfg, self.model, None, tvae_cfg.ch, seed=s_state,
                                            vq_ema=vq_ema, recon_only=True)
            shard_state(self.state, self.mesh)
            self._step = make_train_step_3d(cfg, tvae_cfg, self.model, group=group,
                                            context=context)

        # the eval's model: the deterministic latent, scored with the Polyak
        # weights where they are tracked
        with torch.device(dev):
            self.eval_model = TVAE(tvae_cfg)
        to_channels_last(self.eval_model)
        self.eval_model.requires_grad_(False).eval()

        run_dir = os.path.join(cfg.ckpt_dir, cfg.run_name)
        self.logger = MetricLogger(cfg.run_name, cfg.project_name, use_wandb=cfg.use_wandb,
                                   out_dir=run_dir, is_master=self.is_master)
        self.ckpt = CheckpointManager(os.path.join(run_dir, "state"))
        self._eval_metric_failures = 0
        # startup weights: load_path (above), else the run's latest full state
        # (every rank reads the same file)
        if not cfg.load_path and self.ckpt.latest_step() is not None:
            if self.ckpt.restore(self.state) is not None:
                self.logger.info(f"Resumed 3D train state from step {self.state.step}")
        check_replicas(self.mesh, self.state, "at the start")

    @property
    def start_step(self) -> int:
        return int(self.state.step)

    def save(self, step: int) -> None:
        """The full train state as step ``step`` (host copy now, the file
        written in the background), by rank 0 between two barriers of every
        rank; a sharded state's ranks first gather the tree together."""
        self.mesh.barrier()
        self.ckpt.wait()  # one host copy at a time
        tree = state_dict_of(self.state, keep=self.is_master)
        if self.is_master:
            self.ckpt.save(step, tree)
        self.mesh.barrier()

    # ------------------------------------------------------------------
    def _train_source(self):
        """This data index's clips: its shards of the stream (the context
        ranks of one data index read the same), or the synthetic clips."""
        cfg = self.cfg
        seed = cfg.seed + self.start_step  # a fresh order on resume
        if cfg.dataset_url and not cfg.synthetic_data:
            return create_video_dataloader(cfg.dataset_url, self.local_batch, self.frames,
                                           self.tvae_cfg.resolution,
                                           num_workers=cfg.num_workers, seed=seed,
                                           process_index=self.mesh.data_index,
                                           process_count=self.mesh.n_data)
        return synthetic_video_batches(self.local_batch, self.frames, self.tvae_cfg.resolution,
                                       seed=seed)

    def _own_frames(self, src):
        """This rank's T block of each of its data index's clip batches."""
        res = self.tvae_cfg.resolution
        (_, _), (t0, t1) = self.mesh.batch_block(
            (self.cfg.batch_size, self.frames, res, res, 3))[:2]
        for clips in src:
            yield np.asarray(clips)[:, t0:t1]

    def _eval_batch(self) -> Optional[torch.Tensor]:
        """The fixed eval batch of ``local_batch`` clips, the same across
        restarts (rank 0 only): real data reads ``test_dataset_url`` (or the
        train shards, with a logged caveat) unshuffled at ``seed``;
        synthetic data its own seed stream."""
        cfg = self.cfg
        if cfg.eval_batches <= 0 or not self.is_master:
            return None
        res = self.tvae_cfg.resolution
        if cfg.dataset_url and not cfg.synthetic_data:
            url = cfg.test_dataset_url or cfg.dataset_url
            if not cfg.test_dataset_url:
                self.logger.info("3d eval: no --test_dataset_url; eval clips come from the "
                                 "training shards (metrics optimistic)")
            src = create_video_dataloader(url, self.local_batch, self.frames, res,
                                          num_workers=1, do_shuffle=False, seed=cfg.seed,
                                          loop=False)
            try:
                batch = next(src)
            finally:
                src.close()  # one batch is enough: stop the decode worker
        else:
            batch = next(synthetic_video_batches(self.local_batch, self.frames, res,
                                                 seed=cfg.seed + EVAL_SEED_OFFSET))
        return to_device(np.asarray(batch), self.device)

    @torch.no_grad()
    def _eval(self, step: int, batch: torch.Tensor, params: dict[str, torch.Tensor]) -> None:
        """Deterministic reconstruction of the eval clips (the posterior mean,
        or straight quantization without a statistics update), quality
        metrics over the B·T frames, and a strip of the first clip's frames,
        originals above reconstructions. ``params``: what ``eval_params``
        gathered (the Polyak EMA weights when tracked, else G's)."""
        model = self.eval_model
        for name, p in model.named_parameters():
            p.copy_(params[name])
        z = model.encode(batch)
        recon = model.decode(model.deterministic_latent(z)).float()
        ra = (recon * 0.5 + 0.5).clamp(0.0, 1.0)
        ta = (batch.float() * 0.5 + 0.5).clamp(0.0, 1.0)
        try:
            flat_r, flat_t = flat_frames(ra), flat_frames(ta)
            vals = {
                "eval/recon_l2": float((ra - ta).square().mean()),
                "eval/psnr": float(psnr(flat_r, flat_t)),
                "eval/ssim": float(ssim(flat_r, flat_t)),
            }
            if self.use_gan:
                # per-frame perceptual distance with the training LPIPS
                vals["eval/lpips"] = float(self.lpips(flat_r * 2.0 - 1.0,
                                                      flat_t * 2.0 - 1.0).mean())
            self.logger.log(vals, step)
        except Exception:
            # metrics never kill training, but a silent drop hides a
            # regression: log the traceback and a counter metric
            self._eval_metric_failures += 1
            self.logger.info("3d eval metrics failed (training continues):\n"
                             + traceback.format_exc())
            self.logger.log({"eval/metrics_failed": self._eval_metric_failures}, step)
        k = min(4, ta.shape[1])
        ta0, ra0 = ta[0, :k].cpu().numpy(), ra[0, :k].cpu().numpy()
        strip = np.concatenate([np.concatenate(list(ta0), axis=1),
                                np.concatenate(list(ra0), axis=1)], axis=0)
        self.logger.log_images({"reconstructed_clip_frames": strip}, step,
                               os.path.join(self.cfg.ckpt_dir, self.cfg.run_name, "eval"))

    def _eval_on_master(self, step: int, eval_batch: Optional[torch.Tensor]) -> None:
        """``_eval`` where the eval batch is (rank 0, eval on); under fsdp
        every rank takes part in the gather first, when eval is on."""
        if self.cfg.eval_batches <= 0:
            return
        params = eval_params(self.state, keep=eval_batch is not None)
        if eval_batch is not None:
            self._eval(step, eval_batch, params)

    def _guard_finite(self, metrics: Optional[dict], step: int) -> None:
        """The NaN guard at every checkpoint site: halt before overwriting
        the last good state."""
        if not self.cfg.nan_guard or metrics is None:
            return
        vals = _host_metrics(metrics)
        bad = {k: v for k, v in vals.items() if not np.isfinite(v)}
        if bad:
            self.logger.info(f"NaN guard tripped at 3d step {step}: {bad} — halting without "
                             f"checkpointing")
            raise DivergenceError(f"non-finite metrics at step {step}: {bad}")

    def train(self) -> TVAE:
        """Train to ``max_steps``; returns G (under fsdp gathered whole
        again on every rank)."""
        cfg = self.cfg
        src = self._train_source()
        eval_batch = self._eval_batch()
        metrics = None
        try:
            batches = device_prefetch(self._own_frames(src) if self.mesh.n_context > 1
                                      else src, self.device)
            for step in range(self.start_step, cfg.max_steps):
                self.state, metrics = self._step(self.state, next(batches))
                if step % cfg.log_every == 0:
                    vals = _host_metrics(metrics)
                    self.logger.log(vals, step)
                    self.logger.info(f"3d step {step}: "
                                     + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
                # n == 1 means every step; (step + 1) % n == 1 otherwise
                n = cfg.evaluate_every_n_steps
                if n > 0 and (n == 1 or (step + 1) % n == 1):
                    self._guard_finite(metrics, step)
                    self._eval_on_master(step, eval_batch)
                    self.save(step + 1)
        finally:
            # stop the decode workers whether the loop finished or raised
            if hasattr(src, "close"):
                src.close()
        self._guard_finite(metrics, cfg.max_steps)
        self._eval_on_master(cfg.max_steps, eval_batch)
        self.save(cfg.max_steps)
        self.ckpt.wait()
        self.mesh.barrier()  # the last checkpoint is on disk for every rank
        self.state.layout.gather_models(self.state)
        self.logger.close()
        return self.model
