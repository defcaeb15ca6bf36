"""Training orchestration: models, data, the train step, eval and
checkpoints (counterpart of ``vqgan_tpu/train/trainer.py``; the
reference's ``train_ddp``, vae_trainer.py:339-912).

Data parallelism: under ``torchrun --nproc_per_node N`` with
``mesh_shape`` ``data=-1`` (or ``data=N``, or ``data=D,fsdp=F`` with D·F =
N) each rank is a process on its card (``cuda:LOCAL_RANK``),
``batch_size`` is the global batch and each rank feeds ``batch_size / N``
of it; the step is the one-process step on the global batch
(``train/step.py``, ``parallel/mesh.py``). Every rank initializes from the
seed and rank 0's parameters are broadcast; with ``fsdp`` F > 1 each rank
then keeps its block of every tensor the rule shards
(``parallel/fsdp.py``); the ranks' states are checked equal, block by
block across the data axis. Rank 0 alone evaluates, logs and writes
checkpoints, the others waiting at a barrier (under fsdp every rank first
takes part in gathering what eval scores and what a save writes); every
rank resumes from the same file, of any layout. The ``tensor`` and
``context`` axes and the context-parallel feed are not ported (ROADMAP.md
Queue 1). Everything else
keeps the JAX trainer's order and cadence: the seeded init, ``load_path`` /
``lpips_weights`` / ``disc_backbone_weights``, the full-state resume, the
data stream reseeded by the resume step (indexed data resumes sample-exact),
the crop coin from ``np.random.default_rng(seed)``, the log cadence, the NaN
guard at every checkpoint site, eval and save at ``global_step % n == 1``,
the SIGTERM/SIGINT save, and the two kinds of checkpoint.

Models are built on an explicit device, ``"cuda"`` unless the caller asks
for ``"cpu"``; there is no fallback from one to the other.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from vqgan_tpu_torch.config import TrainConfig, VAEConfig, parse_mesh_shape
from vqgan_tpu_torch.data.loader import create_dataloader, device_prefetch, to_device
from vqgan_tpu_torch.data.synthetic import synthetic_dataloader
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
from vqgan_tpu_torch.losses.fid import frechet_distance, make_feature_fn
from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
from vqgan_tpu_torch.losses.metrics import psnr, ssim
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.models.blocks import init_weights_
from vqgan_tpu_torch.models.quant import VectorQuantizer
from vqgan_tpu_torch.ops.resize import resize_area
from vqgan_tpu_torch.parallel.fsdp import shard_state
from vqgan_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast_,
    create_mesh,
    init_distributed,
    replicas_equal,
)
from vqgan_tpu_torch.train.checkpoint import CheckpointManager, state_dict_of
from vqgan_tpu_torch.train.evaluate import make_eval_step, tile_grid
from vqgan_tpu_torch.train.state import TrainState, create_train_state, state_tensors
from vqgan_tpu_torch.train.step import make_train_step
from vqgan_tpu_torch.utils.logging import MetricLogger
from vqgan_tpu_torch.weights import (
    load_disc_backbone,
    load_lpips_weights,
    load_weights,
)


class DivergenceError(RuntimeError):
    """Raised by the NaN guard: training produced a non-finite loss. The
    trainer halts before the next checkpoint, so the last saved state is
    the last known-good one."""


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that torch cannot see
    raises (there is no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch; pass device='cpu' "
                           "(--device cpu) to train on the CPU")
    return device


def data_parallel(cfg: TrainConfig, device: str | torch.device,
                  context: bool = False) -> tuple[torch.device, Mesh]:
    """This rank's device and the job's mesh (``init_distributed``,
    ``create_mesh``; ``context``: the 3D job, which takes the context
    axis), with the JAX trainer's batch checks: the global ``batch_size``
    divides by the data-parallel extent (data x fsdp), and by
    ``grad_accum`` times it."""
    device = init_distributed(resolve_device(device))
    try:
        mesh = create_mesh(parse_mesh_shape(cfg.mesh_shape), context=context)
    except (ValueError, NotImplementedError) as e:
        raise type(e)(f"mesh_shape {cfg.mesh_shape!r}: {e}") from None
    n = mesh.n_data
    if cfg.batch_size % n:
        raise ValueError(f"global batch_size {cfg.batch_size} must be divisible by the "
                         f"data-parallel extent {n} of mesh {mesh.shape}")
    if cfg.grad_accum > 1 and cfg.batch_size % (cfg.grad_accum * n):
        raise ValueError(f"global batch_size {cfg.batch_size} must be divisible by "
                         f"grad_accum {cfg.grad_accum} x data-parallel extent {n}")
    return device, mesh


@torch.no_grad()
def replicate(mesh: Mesh, modules, extra=()) -> None:
    """Every rank's ``modules`` (their parameters and buffers) and ``extra``
    tensors take rank 0's values."""
    tensors = [t.detach() for m in modules if m is not None
               for t in (*m.parameters(), *m.buffers())]
    broadcast_(tensors + list(extra), mesh.group)


def check_replicas(mesh: Mesh, state: TrainState, what: str) -> None:
    """Raise unless every rank holds rank 0's train state bit for bit:
    under fsdp the whole tensors on every rank, the blocks on the ranks of
    one fsdp index (the data axis)."""
    whole = replicas_equal(state_tensors(state, sharded=False), mesh.group)
    blocks = replicas_equal(state_tensors(state, sharded=True), mesh.replica_group)
    if not (whole and blocks):
        raise RuntimeError(f"the ranks' train states differ {what}")


def eval_params(state: TrainState, keep: bool) -> Optional[dict[str, torch.Tensor]]:
    """What eval scores, whole: the Polyak EMA weights when tracked, else
    G's, by name; None where ``keep`` is false (a rank that does not
    evaluate). Under fsdp a gather: every rank calls it, before rank 0
    alone evaluates (JAX ``evaluate``'s order, ``vqgan_tpu/train/
    trainer.py:453-458``: a gather behind the master gate deadlocks)."""
    params = (state.g_ema if state.g_ema is not None
              else {n: p.detach() for n, p in state.g_model.named_parameters()})
    return state.layout.gather_named(params, keep=keep)


class Trainer:
    """``Trainer(cfg, vae_cfg, device="cuda").train()``."""

    def __init__(self, cfg: TrainConfig, vae_cfg: VAEConfig,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device, self.mesh = data_parallel(cfg, device)
        self.is_master = self.mesh.is_master
        if cfg.crop_invariance and cfg.downscale_factor != vae_cfg.ffactor:
            # the crop step addresses the target at latent_offset *
            # downscale_factor; a mismatch slices out of bounds
            raise ValueError(
                f"--downscale_factor {cfg.downscale_factor} must equal the "
                f"VAE's spatial factor {vae_cfg.ffactor} "
                f"(2^(len(ch_mult)-1)) for latent-crop equivariance"
            )
        if cfg.full_bf16:
            vae_cfg = dataclasses.replace(vae_cfg, enc_dtype="bfloat16", dec_dtype="bfloat16")
        self.vae_cfg = vae_cfg

        # deterministic seeding: one generator for each of G, D, LPIPS and
        # the step's draws, from cfg.seed
        s_g, s_d, s_lpips, s_state = (int(s) for s in
                                      np.random.SeedSequence(cfg.seed).generate_state(4))
        dev = self.device

        def gen(seed: int) -> torch.Generator:
            return torch.Generator(device=dev).manual_seed(seed)

        with torch.device(dev):
            self.vae = VAE(vae_cfg)
        init_weights_(self.vae, gen(s_g))
        vq_ema = None
        if isinstance(self.vae.reg, VectorQuantizer) and self.vae.reg.ema_decay > 0:
            # the JAX init's statistics: counts 1, sums the initial codebook
            vq_ema = self.vae.reg.init_ema()
        if cfg.load_path:
            self.vae.load_state_dict(load_weights(cfg.load_path), strict=True)

        # the reference runs D and LPIPS in fp32 (vae_trainer.py:630,676);
        # --full_bf16 moves their compute to bf16 (params stay fp32)
        loss_dtype = torch.bfloat16 if cfg.full_bf16 else torch.float32
        self.disc = None
        if cfg.do_ganloss:
            with torch.device(dev):
                self.disc = PatchDiscriminator(loss_dtype)
            init_discriminator_(self.disc, gen(s_d))
            if cfg.disc_backbone_weights:
                backbone = load_disc_backbone(cfg.disc_backbone_weights)
                missing, unexpected = self.disc.load_state_dict(backbone, strict=False)
                if unexpected or any(k.startswith("slice") for k in missing):
                    raise KeyError(f"{cfg.disc_backbone_weights}: not a VGG16 backbone "
                                   f"(missing {missing}, unexpected {unexpected})")
        with torch.device(dev):
            self.lpips = LPIPS(loss_dtype)
        init_lpips_(self.lpips, gen(s_lpips))
        if cfg.lpips_weights:
            self.lpips.load_state_dict(load_lpips_weights(cfg.lpips_weights), strict=True)

        # every rank starts from rank 0's weights (the seeded init is the
        # same everywhere; the broadcast makes it so by construction)
        replicate(self.mesh, (self.vae, self.disc, self.lpips),
                  vq_ema.values() if vq_ema is not None else ())
        self.state = shard_state(create_train_state(cfg, self.vae, self.disc, vae_cfg.ch,
                                                    seed=s_state, vq_ema=vq_ema), self.mesh)
        self._step = make_train_step(cfg, vae_cfg, self.vae, self.disc, self.lpips,
                                     gradnorm_shards=self.mesh.n_data, group=self.mesh.group)
        self._eval_step = make_eval_step(cfg, vae_cfg, self.vae)

        run_dir = os.path.join(cfg.ckpt_dir, cfg.run_name)
        self.logger = MetricLogger(
            cfg.run_name,
            cfg.project_name,
            config={**vae_cfg.__dict__, **cfg.__dict__},
            use_wandb=cfg.use_wandb,
            out_dir=run_dir,
            is_master=self.is_master,
        )
        self.ckpt = CheckpointManager(os.path.join(run_dir, "state"))
        self._np_rng = np.random.default_rng(cfg.seed)
        if self.mesh.group is not None:
            self.logger.info(f"mesh {self.mesh.shape}: {self.mesh.world_size} ranks, backend "
                             f"{torch.distributed.get_backend(self.mesh.group)}, rank 0 on "
                             f"{self.device}; {self.local_batch} of the global batch "
                             f"{cfg.batch_size} a rank")

        # preemption recovery: with no explicit --load_path, resume the full
        # train state from the latest checkpoint of this run — exact
        # continuation, unlike the reference's weights-only restarts
        # (vae_trainer.py:505-513); every rank reads the same file
        if not cfg.load_path and self.ckpt.latest_step() is not None:
            if self.ckpt.restore(self.state) is not None:
                self.logger.info(f"Resumed full train state from step {self.state.step}")
        check_replicas(self.mesh, self.state, "at the start")

    @property
    def local_batch(self) -> int:
        """This rank's share of the global batch (JAX ``_local_batch``)."""
        return self.cfg.batch_size // self.mesh.n_data

    # ------------------------------------------------------------------
    def _data_epoch_offset(self, train: bool) -> int:
        """The train stream's seed folds in the resume step, so a resume at
        step S continues on a fresh but reproducible order instead of
        replaying the run's first batches (the streaming reader has no
        sample-exact cursor). Eval keeps the base seed, so the cached eval
        batches are the same across restarts."""
        return int(self.state.step) if train else 0

    def _make_loader(self, train: bool):
        cfg = self.cfg
        off = self._data_epoch_offset(train)
        if cfg.synthetic_data or not (cfg.dataset_url if train else cfg.test_dataset_url):
            # multiplicative fold, so a resumed train stream never takes the
            # eval stream's seed 1
            # every rank makes the same samples, as the JAX trainer's do
            return synthetic_dataloader(self.local_batch, cfg.image_size,
                                        seed=(0 if train else 1) + 1_000_003 * off)
        url = cfg.dataset_url if train else cfg.test_dataset_url
        # indexed mode: the batch at step S is position-addressed, so resume
        # is sample-exact; the seed stays fixed and start_step fast-forwards
        indexed = cfg.indexed_data and train
        return iter(
            create_dataloader(
                url,
                self.local_batch,
                num_workers=cfg.num_workers,
                do_shuffle=train,
                just_resize=not train,
                width=cfg.image_size,
                seed=cfg.seed if indexed else cfg.seed + 1_000_003 * off,
                device_normalize=cfg.device_normalize,
                indexed=indexed,
                start_step=off if indexed else 0,
                process_index=self.mesh.rank,
                process_count=self.mesh.world_size,
            )
        )

    # ------------------------------------------------------------------
    def _install_preemption_handler(self):
        """SIGTERM/SIGINT → checkpoint the full train state before exiting
        (the reference loses the optimizer state on any interruption)."""
        self._preempted = False

        def handler(signum, frame):
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:  # not in the main thread
                pass

    def train(self) -> None:
        cfg = self.cfg
        self._install_preemption_handler()
        loader = device_prefetch(self._make_loader(True), self.device)
        test_loader = self._make_loader(False) if self.is_master else None
        global_step = int(self.state.step)
        t0 = time.time()
        metrics = {}
        profiler = None
        metrics_device = None  # the most recent step's metrics, on the device
        metrics_checked = True  # whether the NaN guard vetted them

        for epoch in range(cfg.num_epochs):
            for batch in loader:
                if global_step >= cfg.max_steps:
                    break
                if self.mesh.any(self._preempted):  # every rank stops at this step
                    self.logger.info(
                        f"Preemption signal received — checkpointing at step {global_step}")
                    self._guard_latest(metrics_device, metrics_checked, global_step)
                    self.save(global_step, epoch)
                    self._finish()
                    return
                time_taken_till_load = time.time() - t0
                t0 = time.time()

                if cfg.profile_dir and global_step == 10 and self.is_master:
                    profiler = self._start_profiler()

                # 50/50 crop step (reference :577), uniform over the static
                # crop-size buckets
                do_crop = 0
                if cfg.crop_invariance and self._np_rng.random() < 0.5:
                    do_crop = 1 + int(self._np_rng.integers(len(cfg.crop_fractions)))
                self.state, metrics_device = self._step(self.state, batch, do_crop)
                metrics_checked = False

                if profiler is not None and global_step == 15:
                    self._stop_profiler(profiler)
                    profiler = None

                log_now = global_step % cfg.log_every == 0
                if log_now:
                    metrics = _host_metrics(metrics_device)
                    if cfg.nan_guard:
                        self._guard_finite(metrics, global_step)
                        metrics_checked = True
                time_taken_till_step = time.time() - t0

                if log_now:
                    metrics["epoch"] = epoch
                    metrics["time_taken_till_step"] = time_taken_till_step
                    metrics["time_taken_till_load"] = time_taken_till_load
                    self.logger.log(metrics, global_step)
                    self.logger.info(
                        f"Epoch [{epoch}/{cfg.num_epochs}] step {global_step}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items())
                                   if isinstance(v, float))
                    )
                if global_step % 200 == 0 and metrics:
                    # per-200-step stepwise keys (vae_trainer.py:753-765)
                    self.logger.log(
                        {f"loss_stepwise/overall_vae_loss_{global_step}":
                         metrics.get("overall_vae_loss", 0.0)},
                        global_step,
                    )

                global_step += 1
                t0 = time.time()

                # eval + checkpoint cadence (trigger % n == 1, reference
                # vae_trainer.py:805-809; n == 1 means every step)
                _n = cfg.evaluate_every_n_steps
                if _n > 0 and (_n == 1 or global_step % _n == 1):
                    # last line of defense before overwriting checkpoints
                    metrics_checked = self._guard_latest(metrics_device, metrics_checked,
                                                         global_step)
                    # every rank: a gather under fsdp
                    params = eval_params(self.state, keep=self.is_master)
                    if self.is_master:  # the others wait at the save's barrier
                        self.evaluate(global_step, epoch, test_loader, params)
                    del params
                    self.save(global_step, epoch)
            if global_step >= cfg.max_steps:
                break
        if profiler is not None:
            self._stop_profiler(profiler)
        self._guard_latest(metrics_device, metrics_checked, global_step)
        self.save(global_step, None)
        self._finish()
        self.logger.close()

    def _finish(self) -> None:
        """The end of ``train``: the last checkpoint on disk for every rank,
        and under fsdp ``vae`` and ``disc`` whole again on every rank (a
        gather), so that the trained modules can be used as they are."""
        self.ckpt.wait()
        self.mesh.barrier()
        self.state.layout.gather_models(self.state)

    # ------------------------------------------------------------------
    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stop ``profiler`` and write its chrome trace of steps 10-15 to
        ``profile_dir/trace.json``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        self.logger.info(f"Wrote the profile of steps 10-15 to {path}")

    # ------------------------------------------------------------------
    def _guard_latest(self, metrics_device, already_checked: bool, step: int) -> bool:
        """Every checkpoint site (eval cadence, preemption, end of training)
        funnels through here: vet the most recent step's metrics unless the
        log branch already did for this step. Returns True once checked."""
        if not self.cfg.nan_guard or already_checked or metrics_device is None:
            return already_checked
        self._guard_finite(_host_metrics(metrics_device), step)
        return True

    def _guard_finite(self, metrics: dict, step: int) -> None:
        bad = {k: v for k, v in metrics.items() if isinstance(v, float) and not np.isfinite(v)}
        if bad:
            self.logger.info(
                f"NaN guard tripped at step {step}: {bad} — halting without "
                f"checkpointing (last saved state remains the last good one)"
            )
            raise DivergenceError(f"non-finite metrics at step {step}: {bad}")

    # ------------------------------------------------------------------
    def evaluate(self, step: int, epoch: int, test_loader,
                 g_params: dict[str, torch.Tensor]) -> None:
        # ``g_params``: ``eval_params``' (the Polyak-averaged weights when
        # EMA is on; training itself stays on the raw weights)
        # a fixed eval set: the reference restarts its test dataloader every
        # eval, so it always scores the same first batches
        # (vae_trainer.py:815-861) — cache them once
        if not hasattr(self, "_eval_batches"):
            self._eval_batches = [to_device(next(test_loader), self.device)
                                  for _ in range(self.cfg.eval_batches)]
        pairs = [self._eval_step(g_params, batch) for batch in self._eval_batches]
        recon = torch.cat([r for r, _ in pairs])
        target = torch.cat([t for _, t in pairs])

        # quality metrics: eval/lpips on the recon pairs, the VGG-Fréchet
        # proxy eval/rfid_vgg_proxy, PSNR and SSIM
        try:
            if recon.shape != target.shape:
                # image_size != the recon resolution: score against the
                # area-resized target at recon resolution; the image grids
                # keep the original target
                target_m = resize_area(target, tuple(recon.shape[1:3]))
            else:
                target_m = target
            if not hasattr(self, "_eval_feats"):
                self._eval_feats = make_feature_fn(self.lpips.net.state_dict(), self.device,
                                                   taps=self.cfg.rfid_taps)
                # in-band caveat, once per run: a proxy statistic (VGG taps,
                # not Inception-pool3), on a random-init VGG without
                # --lpips_weights
                self.logger.info(
                    "eval/rfid_vgg_proxy caveat: Fréchet distance over "
                    f"VGG taps {tuple(self.cfg.rfid_taps)} "
                    f"({'pretrained' if self.cfg.lpips_weights else 'random-init'} VGG), "
                    "not Inception rFID — comparable within this run, not "
                    "to published rFID numbers"
                )
            a, b = recon * 2.0 - 1.0, target_m * 2.0 - 1.0
            with torch.no_grad():
                lp_val = float(self.lpips(a, b).mean())
            fa = self._eval_feats(a).cpu().numpy()
            fb = self._eval_feats(b).cpu().numpy()
            rfid = frechet_distance(fa, fb)
            self.logger.log(
                {
                    "eval/lpips": lp_val,
                    "eval/rfid_vgg_proxy": rfid,
                    "eval/psnr": float(psnr(recon, target_m)),
                    "eval/ssim": float(ssim(recon, target_m)),
                },
                step,
            )
        except Exception:
            # metrics never kill training — but a silent drop hides a
            # regression: log the traceback and a counter metric
            import traceback

            self._eval_metric_failures = getattr(self, "_eval_metric_failures", 0) + 1
            self.logger.info("eval metrics failed (training continues):\n"
                             + traceback.format_exc())
            self.logger.log({"eval/metrics_failed": self._eval_metric_failures}, step)
        d = 512 if self.vae_cfg.decoder_also_perform_hr else 256
        out_dir = os.path.join(self.cfg.ckpt_dir, self.cfg.run_name, "eval")
        self.logger.log_images(
            {
                "reconstructed_test_images": tile_grid(recon.cpu().numpy(), 2, 4, d),
                "test_images": tile_grid(target.cpu().numpy(), 2, 4, d),
            },
            step,
            out_dir,
        )
        self.logger.info(f"Epoch [{epoch}] - Logged test images at step {step}")

    def save(self, step: int, epoch: Optional[int]) -> None:
        """The full state (``CheckpointManager``), and the raw weights as a
        reference-format ``.pt``, with the Polyak average beside it as
        ``*_ema.pt`` when EMA is on. The loop waits for one host copy of the
        state; the manager's background thread writes all three files
        (``self.ckpt.wait()`` joins it). Rank 0 alone saves, between two
        barriers of every rank; a sharded state's ranks first gather the
        tree together (``state_dict_of``)."""
        self.mesh.barrier()
        self.ckpt.wait()  # one host copy at a time
        tree = state_dict_of(self.state, keep=self.is_master)
        if self.is_master:
            self._save(step, epoch, tree)
        self.mesh.barrier()

    def _save(self, step: int, epoch: Optional[int], tree: dict) -> None:
        path = os.path.join(
            self.cfg.ckpt_dir,
            self.cfg.run_name,
            f"vae_epoch_{epoch if epoch is not None else 'final'}_step_{step}.pt",
        )
        weights = {path: "g_model"}
        if self.state.g_ema is not None:
            # the production artifact: the Polyak-averaged weights, in the
            # same reference-layout .pt
            weights[path[:-3] + "_ema.pt"] = "g_ema"
        self.ckpt.save(step, tree, weights)
        self.logger.info(f"Saving checkpoint to {' and '.join(weights)} and the full state "
                         f"(written in the background)")


def _host_metrics(metrics_device: dict) -> dict[str, float]:
    """The step's 0-d device metrics as floats, in one device-to-host copy."""
    names = list(metrics_device)
    values = torch.stack([metrics_device[k].detach().float() for k in names]).tolist()
    return dict(zip(names, values))
