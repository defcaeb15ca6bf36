"""Training orchestration for the 3D video VAE (TVAE) on one device
(counterpart of ``vqgan_tpu/train/trainer3d.py``).

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
rematerialized regions. Not ported: the mesh, the multi-host feed and the
context-parallel ring attention (a mesh of several devices raises
NotImplementedError, ROADMAP.md Queue 1: multi-GPU).

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
from vqgan_tpu_torch.models.tae import TVAE, init_weights_
from vqgan_tpu_torch.train.checkpoint import CheckpointManager
from vqgan_tpu_torch.train.state import create_train_state, to_channels_last
from vqgan_tpu_torch.train.step3d import flat_frames, make_train_step_3d, make_train_step_3d_gan
from vqgan_tpu_torch.train.trainer import (
    DivergenceError,
    _host_metrics,
    one_device_mesh,
    resolve_device,
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
        self.device = resolve_device(device)
        one_device_mesh(cfg.mesh_shape)  # a context axis too: no ring attention
        if cfg.grad_accum > 1 and cfg.batch_size % cfg.grad_accum:
            raise ValueError(f"--batch_size {cfg.batch_size} must divide by grad_accum "
                             f"{cfg.grad_accum}")
        self.use_gan = cfg.do_ganloss

        # one generator for each of G, D, LPIPS and the step's draws, from
        # cfg.seed
        s_g, s_d, s_lpips, s_state = (int(s) for s in
                                      np.random.SeedSequence(cfg.seed).generate_state(4))
        dev = self.device

        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=dev).manual_seed(seed)

        with torch.device(dev):
            self.model = TVAE(tvae_cfg)
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
            self.state = create_train_state(cfg, self.model, self.disc, tvae_cfg.ch,
                                            seed=s_state, vq_ema=vq_ema)
            self._step = make_train_step_3d_gan(cfg, tvae_cfg, self.model, self.disc,
                                                self.lpips)
        else:
            # one AdamW at the constant lr learning_rate_vae / ch
            self.state = create_train_state(cfg, self.model, None, tvae_cfg.ch, seed=s_state,
                                            vq_ema=vq_ema, recon_only=True)
            self._step = make_train_step_3d(cfg, tvae_cfg, self.model)

        # the eval's model: the deterministic latent, scored with the Polyak
        # weights where they are tracked
        with torch.device(dev):
            self.eval_model = TVAE(tvae_cfg)
        to_channels_last(self.eval_model)
        self.eval_model.requires_grad_(False).eval()

        run_dir = os.path.join(cfg.ckpt_dir, cfg.run_name)
        self.logger = MetricLogger(cfg.run_name, cfg.project_name, use_wandb=cfg.use_wandb,
                                   out_dir=run_dir)
        self.ckpt = CheckpointManager(os.path.join(run_dir, "state"))
        self._eval_metric_failures = 0
        # startup weights: load_path (above), else the run's latest full state
        if not cfg.load_path and self.ckpt.latest_step() is not None:
            if self.ckpt.restore(self.state) is not None:
                self.logger.info(f"Resumed 3D train state from step {self.state.step}")

    @property
    def start_step(self) -> int:
        return int(self.state.step)

    def _eval_params(self) -> dict[str, torch.Tensor]:
        """What eval scores: the Polyak EMA weights when tracked, else G's."""
        if self.state.g_ema is not None:
            return self.state.g_ema
        return dict(self.model.named_parameters())

    def save(self, step: int) -> None:
        """The full train state as step ``step`` (host copy now, the file
        written in the background)."""
        self.ckpt.save(step, self.state)

    # ------------------------------------------------------------------
    def _train_source(self):
        cfg = self.cfg
        seed = cfg.seed + self.start_step  # a fresh order on resume
        if cfg.dataset_url and not cfg.synthetic_data:
            return create_video_dataloader(cfg.dataset_url, cfg.batch_size, self.frames,
                                           self.tvae_cfg.resolution,
                                           num_workers=cfg.num_workers, seed=seed)
        return synthetic_video_batches(cfg.batch_size, self.frames, self.tvae_cfg.resolution,
                                       seed=seed)

    def _eval_batch(self) -> Optional[torch.Tensor]:
        """The fixed eval batch, the same across restarts: real data reads
        ``test_dataset_url`` (or the train shards, with a logged caveat)
        unshuffled at ``seed``; synthetic data its own seed stream."""
        cfg = self.cfg
        if cfg.eval_batches <= 0:
            return None
        res = self.tvae_cfg.resolution
        if cfg.dataset_url and not cfg.synthetic_data:
            url = cfg.test_dataset_url or cfg.dataset_url
            if not cfg.test_dataset_url:
                self.logger.info("3d eval: no --test_dataset_url; eval clips come from the "
                                 "training shards (metrics optimistic)")
            src = create_video_dataloader(url, cfg.batch_size, self.frames, res,
                                          num_workers=1, do_shuffle=False, seed=cfg.seed,
                                          loop=False)
            try:
                batch = next(src)
            finally:
                src.close()  # one batch is enough: stop the decode worker
        else:
            batch = next(synthetic_video_batches(cfg.batch_size, self.frames, res,
                                                 seed=cfg.seed + EVAL_SEED_OFFSET))
        return to_device(np.asarray(batch), self.device)

    @torch.no_grad()
    def _eval(self, step: int, batch: torch.Tensor) -> None:
        """Deterministic reconstruction of the eval clips (the posterior mean,
        or straight quantization without a statistics update), quality
        metrics over the B·T frames, and a strip of the first clip's frames,
        originals above reconstructions."""
        model = self.eval_model
        params = self._eval_params()
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
        """Train to ``max_steps``; returns G."""
        cfg = self.cfg
        src = self._train_source()
        eval_batch = self._eval_batch()
        metrics = None
        try:
            batches = device_prefetch(src, self.device)
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
                    if eval_batch is not None:
                        self._eval(step, eval_batch)
                    self.save(step + 1)
        finally:
            # stop the decode workers whether the loop finished or raised
            if hasattr(src, "close"):
                src.close()
        self._guard_finite(metrics, cfg.max_steps)
        if eval_batch is not None:
            self._eval(cfg.max_steps, eval_batch)
        self.save(cfg.max_steps)
        self.ckpt.wait()
        self.logger.close()
        return self.model
