"""CLI — the training commands with the JAX package's flag surface
(counterpart of ``vqgan_tpu/cli.py``; the reference's flags,
vae_trainer.py:224-338), in argparse.

Launch:  python -m vqgan_tpu_torch.cli [flags]          (defaults to ``train``)
         python -m vqgan_tpu_torch.cli train [flags] [--device cpu]
         python -m vqgan_tpu_torch.cli train3d [flags] [--device cpu]

Every flag of ``vqgan_tpu.cli train`` and of ``vqgan_tpu.cli train3d`` is
here with the same name and default. In ``train``, ``--do_ganloss`` and
``--do_clamp`` are switches; every other boolean, and every boolean of
``train3d`` (``--do_ganloss true``), takes a value (1/0, true/false, t/f,
yes/no, y/n, on/off), as click parses ``type=bool``. ``--device`` (default
``cuda``) picks the card, or the CPU when asked; a missing card raises.

``--use_wavelet``, ``--grad_accum`` (microbatches a step), ``--remat`` and
``--remat_policy`` (``torch.utils.checkpoint`` regions over the model's levels
and blocks, LPIPS and D) run as in the JAX package; the repo's HDR recipe
(``tools/launch_hdr.sh``) trains here with the same flags.

Flags that steer TPU lowerings are accepted, each saying in its help what it
does here: ``--do_compile``, ``--use_pallas_gn`` (the CUDA GroupNorm kernels
are the only GroupNorm), ``--upsample_impl`` (every value computes the direct
form), ``--conv3d_impl`` (which values run the Conv3d kernel) and
``--max_spatial_dim``, which the JAX CLI reads into nothing either.
Data parallelism: ``torchrun --nproc_per_node N -m vqgan_tpu_torch.cli
train|train3d --mesh_shape data=-1 ...`` runs N ranks, each on its card
(``cuda:LOCAL_RANK``; ranks that share a card talk over gloo), with
``--batch_size`` the global batch; ``--mesh_shape data=D,fsdp=F`` (or
``fsdp=-1``) also shards the train state over F ranks; ``--mesh_shape
data=D,context=C`` splits each image's H rows (``train``: H halos) or each
clip's T frames (``train3d``: T halos) over C ranks, with ring attention and
the two-pass GroupNorm. ``tensor`` above 1, and ``fsdp`` with ``context``,
raise NotImplementedError naming their ROADMAP.md items.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from vqgan_tpu_torch.config import TrainConfig, TVAEConfig, VAEConfig, parse_ch_mult
from vqgan_tpu_torch.inference import _bool

NO_EFFECT = " (no effect in the PyTorch port: {})"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vqgan_tpu_torch.cli [train]",
        description="Train the 2D image VAE (optionally GAN) on a CUDA device, or data-"
                    "parallel on several under torchrun.",
    )
    add = p.add_argument
    add("--dataset_url", type=str, default="", help="URL for the training dataset")
    add("--test_dataset_url", type=str, default="", help="URL for the test dataset")
    add("--num_epochs", type=int, default=2, help="Number of training epochs")
    add("--batch_size", type=int, default=8, help="Batch size for training")
    add("--do_ganloss", action="store_true", help="Whether to use GAN loss")
    add("--learning_rate_vae", type=float, default=1e-5, help="Learning rate for VAE")
    add("--learning_rate_disc", type=float, default=2e-4,
        help="Learning rate for discriminator")
    add("--vae_resolution", type=int, default=256, help="Resolution for VAE")
    add("--vae_in_channels", type=int, default=3, help="Input channels for VAE")
    add("--vae_ch", type=int, default=256, help="Base channel size for VAE")
    add("--vae_ch_mult", type=str, default="1,2,4,4", help="Channel multipliers for VAE")
    add("--vae_num_res_blocks", type=int, default=2,
        help="Number of residual blocks for VAE")
    add("--vae_z_channels", type=int, default=16, help="Number of latent channels for VAE")
    add("--run_name", type=str, default="run", help="Name of the run")
    add("--max_steps", type=int, default=1000, help="Maximum number of steps to train for")
    add("--evaluate_every_n_steps", type=int, default=250, help="Evaluate every n steps")
    add("--load_path", type=str, default=None,
        help="Reference-format .pt to start G from (else the run dir's latest full "
             "state resumes)")
    add("--do_clamp", action="store_true", help="Whether to clamp the latent codes")
    add("--clamp_th", type=float, default=8.0, help="Clamp threshold for the latent codes")
    add("--max_spatial_dim", type=int, default=256,
        help="Maximum spatial dimension for overall training"
             + NO_EFFECT.format("the JAX CLI reads it into nothing either"))
    add("--do_attn", type=_bool, default=False, help="Whether to use attention in the VAE")
    add("--decoder_also_perform_hr", type=_bool, default=False,
        help="Whether to perform HR decoding in the decoder")
    add("--project_name", type=str, default="vae_sweep_attn_lr_width",
        help="Project name for logging")
    add("--crop_invariance", type=_bool, default=False,
        help="Whether to perform crop invariance")
    add("--flip_invariance", type=_bool, default=False,
        help="Whether to perform flip invariance")
    add("--do_compile", type=_bool, default=True,
        help="Kept for flag parity" + NO_EFFECT.format("the step runs eagerly"))
    add("--use_wavelet", type=_bool, default=False,
        help="Whether to use wavelet transform in the encoder")
    add("--augment_before_perceptual_loss", type=_bool, default=False,
        help="Whether to augment the images before the perceptual loss")
    add("--downscale_factor", type=int, default=16,
        help="Downscale factor for the latent space")
    add("--use_lecam", type=_bool, default=False, help="Whether to use LeCam regularization")
    add("--disc_type", type=str, default="bce", help="Discriminator type: bce | hinge")
    add("--recon_weight", type=float, default=0.0,
        help="Reconstruction loss weight (the reference hardcodes 0.0, vae_trainer.py:209)")
    add("--z_reg_weight", type=float, default=0.1,
        help="z^2 latent penalty weight (reference 0.1)")
    add("--do_pool_recon", type=_bool, default=True,
        help="True: pooled L1 recon; False: blurriness-heatmap-masked L1")
    add("--reg_type", type=str, default="identity_gaussian",
        help="Latent regularizer: identity_gaussian | gaussian | vq")
    add("--vq_codebook_size", type=int, default=16384, help="VQ codebook size (reg_type=vq)")
    add("--vq_revive_threshold", type=float, default=0.0,
        help="Reseed codes with EMA count below this from batch samples (0=off)")
    add("--mesh_shape", type=str, default="data=-1",
        help="Device mesh: data=-1 (or data=N) splits the global --batch_size over the "
             "torchrun ranks; data=D,fsdp=F (or fsdp=-1) also shards the train state over "
             "F ranks; data=D,context=C splits each image's H rows over C ranks (H halos, "
             "ring attention); tensor above 1, and fsdp with context, raise "
             "NotImplementedError (not ported)")
    add("--remat", type=_bool, default=False,
        help="Activation rematerialization (fit large configs in device memory)")
    add("--remat_policy", type=str, default="full",
        help="Remat residual policy: full (recompute everything) | "
             "conv (save conv outputs, recompute elementwise only)")
    add("--use_pallas_gn", type=_bool, default=False,
        help="Use the Pallas fused GroupNorm+swish kernel"
             + NO_EFFECT.format("the CUDA GroupNorm kernels are the only GroupNorm"))
    add("--attn_chunk", type=int, default=0,
        help="Memory-efficient mid-block attention once H*W tokens exceed this "
             "(0 = dense)")
    add("--attn_impl", type=str, default="auto",
        help="auto | pallas | lax: a CUDA tensor runs the attention kernel whatever "
             "the value; another value raises")
    add("--upsample_impl", type=str, default="auto",
        help="Decoder Upsample blocks: direct | fused | dilated | auto"
             + NO_EFFECT.format("every value computes the direct form"))
    add("--full_bf16", type=_bool, default=False,
        help="Run the encoder, LPIPS and D in bf16 too (perf mode)")
    add("--gradnorm_mode", type=str, default="global",
        help="global = Frobenius norm of the global cotangent; mean_shard_norm = "
             "reference per-rank norm averaging (vae_trainer.py:40-44)")
    add("--synthetic_data", type=_bool, default=False,
        help="Use the deterministic synthetic data source")
    add("--indexed_data", type=_bool, default=True,
        help="Position-addressed tar dataset (default): perfect per-epoch shuffle + "
             "sample-exact resume; false = streaming reader (reseed-based resume)")
    add("--image_size", type=int, default=512,
        help="Loaded image resolution (reference MAX_WIDTH)")
    add("--num_workers", type=int, default=4, help="Decode workers")
    add("--device_normalize", type=_bool, default=True,
        help="Ship uint8 batches; normalize on device (4x less H2D)")
    add("--use_wandb", type=_bool, default=True,
        help="Log to wandb when available (JSONL always)")
    add("--lpips_weights", type=str, default=None,
        help="Path to converted LPIPS weights (.pth or .npz)")
    add("--disc_backbone_weights", type=str, default=None,
        help="Pretrained VGG16 backbone for the discriminator (vgg16_features.npz or a "
             ".pth)")
    add("--ckpt_dir", type=str, default="./ckpt", help="Checkpoint root directory")
    add("--profile_dir", type=str, default=None,
        help="Write a torch.profiler trace of steps 10-15 here")
    add("--seed", type=int, default=42, help="Seed (reference seeds everything to 42)")
    add("--log_every", type=int, default=5,
        help="Metric logging cadence in steps (reference logs every 5)")
    add("--eval_batches", type=int, default=2,
        help="Test batches per eval (reference: 2); raise for tighter rFID")
    add("--nan_guard", type=_bool, default=True,
        help="Halt (without checkpointing) on non-finite loss")
    add("--ema_decay", type=float, default=0.0,
        help="Polyak EMA of generator weights (e.g. 0.999); eval and a *_ema.pt "
             "artifact use the averaged weights. 0 = off (reference behavior)")
    add("--grad_accum", type=int, default=1,
        help="Microbatches per optimizer step: effective batches beyond device "
             "memory (D updates before G sees it, as one big step)")
    add("--device", type=str, default="cuda",
        help="Device to train on: cuda (default; raises without a card; under torchrun "
             "cuda:LOCAL_RANK) or cpu (gloo between ranks)")
    return p


def configs(kw: dict) -> tuple[TrainConfig, VAEConfig]:
    """The configs a parsed flag set describes, built as the JAX CLI builds
    them."""
    vae_cfg = VAEConfig(
        resolution=kw["vae_resolution"],
        in_channels=kw["vae_in_channels"],
        ch=kw["vae_ch"],
        out_ch=kw["vae_in_channels"],
        ch_mult=parse_ch_mult(kw["vae_ch_mult"]),
        num_res_blocks=kw["vae_num_res_blocks"],
        z_channels=kw["vae_z_channels"],
        use_attn=kw["do_attn"],
        decoder_also_perform_hr=kw["decoder_also_perform_hr"],
        use_wavelet=kw["use_wavelet"],
        reg_type=kw["reg_type"],
        vq_codebook_size=kw["vq_codebook_size"],
        vq_revive_threshold=kw["vq_revive_threshold"],
        remat=kw["remat"],
        remat_policy=kw["remat_policy"],
        use_pallas_gn=kw["use_pallas_gn"],
        attn_chunk=kw["attn_chunk"],
        attn_impl=kw["attn_impl"],
        upsample_impl=kw["upsample_impl"],
    )
    cfg = TrainConfig(
        dataset_url=kw["dataset_url"],
        test_dataset_url=kw["test_dataset_url"],
        batch_size=kw["batch_size"],
        num_epochs=kw["num_epochs"],
        image_size=kw["image_size"],
        num_workers=kw["num_workers"],
        device_normalize=kw["device_normalize"],
        synthetic_data=kw["synthetic_data"],
        indexed_data=kw["indexed_data"],
        learning_rate_vae=kw["learning_rate_vae"],
        learning_rate_disc=kw["learning_rate_disc"],
        max_steps=kw["max_steps"],
        do_ganloss=kw["do_ganloss"],
        disc_type=kw["disc_type"],
        use_lecam=kw["use_lecam"],
        recon_weight=kw["recon_weight"],
        z_reg_weight=kw["z_reg_weight"],
        do_pool_recon=kw["do_pool_recon"],
        augment_before_perceptual_loss=kw["augment_before_perceptual_loss"],
        lpips_weights=kw["lpips_weights"],
        disc_backbone_weights=kw["disc_backbone_weights"],
        do_clamp=kw["do_clamp"],
        clamp_th=kw["clamp_th"],
        flip_invariance=kw["flip_invariance"],
        crop_invariance=kw["crop_invariance"],
        downscale_factor=kw["downscale_factor"],
        run_name=kw["run_name"],
        project_name=kw["project_name"],
        evaluate_every_n_steps=kw["evaluate_every_n_steps"],
        load_path=kw["load_path"],
        ckpt_dir=kw["ckpt_dir"],
        seed=kw["seed"],
        log_every=kw["log_every"],
        eval_batches=kw["eval_batches"],
        nan_guard=kw["nan_guard"],
        ema_decay=kw["ema_decay"],
        grad_accum=kw["grad_accum"],
        use_wandb=kw["use_wandb"],
        mesh_shape=kw["mesh_shape"],
        full_bf16=kw["full_bf16"],
        gradnorm_mode=kw["gradnorm_mode"],
        profile_dir=kw["profile_dir"],
    )
    return cfg, vae_cfg


def train(argv: Optional[Sequence[str]] = None):
    """Parse the train flags and run the job; returns the finished
    ``Trainer``."""
    from vqgan_tpu_torch.train.trainer import Trainer

    kw = vars(build_parser().parse_args(argv))
    cfg, vae_cfg = configs(kw)
    trainer = Trainer(cfg, vae_cfg, device=kw["device"])
    trainer.train()
    return trainer


def build_parser_3d() -> argparse.ArgumentParser:
    """The flags of ``vqgan_tpu.cli train3d``, same names and defaults, and
    ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m vqgan_tpu_torch.cli train3d",
        description="Train the 3D video VAE (TVAE) on a CUDA device, or data-parallel on "
                    "several under torchrun. Data: tar shards of "
                    ".npy/.npz clips via --dataset_url, or synthetic moving patterns.",
    )
    add = p.add_argument
    add("--dataset_url", type=str, default="",
        help="Tar shards of .npy/.npz uint8 (T,H,W,3) clip samples (brace ranges OK); "
             "empty = synthetic moving-pattern clips")
    add("--test_dataset_url", type=str, default="",
        help="Held-out clip shards for eval (defaults to dataset_url)")
    add("--num_workers", type=int, default=4, help="Decode workers")
    add("--batch_size", type=int, default=4, help="Clips per step")
    add("--vae_ch", type=int, default=64, help="Base channel size")
    add("--vae_ch_mult", type=str, default="1,2,4,4", help="Channel multipliers")
    add("--vae_num_res_blocks", type=int, default=2, help="Residual blocks per level")
    add("--vae_z_channels", type=int, default=16, help="Latent channels")
    add("--vae_resolution", type=int, default=64, help="Frame resolution")
    add("--frames", type=int, default=8, help="Clip length T")
    add("--reg_type", type=str, default="gaussian", help="gaussian | vq")
    add("--vq_codebook_size", type=int, default=16384, help="VQ codebook size (reg_type=vq)")
    add("--vq_ema_decay", type=float, default=0.99,
        help="EMA codebook update decay (reg_type=vq; 0 = loss-based codebook training)")
    add("--vq_revive_threshold", type=float, default=0.0,
        help="Reseed codes with EMA count below this from batch latents (0=off)")
    add("--remat", type=_bool, default=False,
        help="Level+block rematerialization (memory for long clips)")
    add("--remat_policy", type=str, default="full",
        help="Remat residual policy: full (recompute everything) | "
             "conv (save conv outputs, recompute elementwise only)")
    add("--conv3d_impl", type=str, default="auto",
        help="3x3x3 conv compute: auto and pallas run the Conv3d kernel on a CUDA tensor "
             "(pallas its plain version on the CPU, auto cuDNN's F.conv3d there); mixed "
             "the kernel where both channel counts are >= 128; direct, tap2d and tap2dfat "
             "(TPU lowerings of the same function) run F.conv3d")
    add("--attn_chunk", type=int, default=0,
        help="Exact chunked mid-block attention over this many k/v tokens (0 = dense)")
    add("--attn_impl", type=str, default="auto",
        help="auto | pallas | lax: a CUDA tensor runs the attention kernel whatever the "
             "value; another value raises")
    add("--upsample_impl", type=str, default="auto",
        help="Decoder Upsample3D blocks: direct | fused | dilated | auto"
             + NO_EFFECT.format("every value computes the direct form"))
    add("--fused_gn_swish", type=_bool, default=False,
        help="Fold norm->silu into the GroupNorm kernel (numerics unchanged)")
    add("--learning_rate_vae", type=float, default=1e-2, help="Learning rate for the TVAE")
    add("--do_ganloss", type=_bool, default=False,
        help="Full per-frame GAN/LPIPS stack (PatchDiscriminator + LPIPS + GradNorm "
             "branches + LeCam), D and LPIPS in fp32")
    add("--disc_type", type=str, default="bce", help="bce | hinge")
    add("--use_lecam", type=_bool, default=False, help="LeCam regularization")
    add("--learning_rate_disc", type=float, default=2e-4, help="Learning rate for D")
    add("--video_loss_frames", type=int, default=0,
        help="Frames per clip fed to the perceptual/GAN branches (strided subset, random "
             "phase; 0 = all frames)")
    add("--disc_3d", type=str, default="frame",
        help="Video discriminator: frame (2D patch disc per frame) | tubelet "
             "(spatio-temporal: + identity-init depthwise temporal mixers)")
    add("--ema_decay", type=float, default=0.0,
        help="Polyak EMA of generator weights (GAN path); eval scores the averaged "
             "weights. 0 = off")
    add("--grad_accum", type=int, default=1,
        help="Microbatches per optimizer step: effective clip batches beyond device "
             "memory (D updates before G sees it, as one big step)")
    add("--max_steps", type=int, default=1000, help="Steps to train to")
    add("--run_name", type=str, default="tvae_run", help="Name of the run")
    add("--mesh_shape", type=str, default="data=-1",
        help="Device mesh: data=-1 (or data=N) splits the global --batch_size over the "
             "torchrun ranks; data=D,fsdp=F (or fsdp=-1) also shards the train state over "
             "F ranks; data=D,context=C splits each clip's T frames over C ranks (ring "
             "attention over the mid block, T halos around every conv); tensor above 1, "
             "and fsdp with context, raise NotImplementedError (not ported)")
    add("--use_wandb", type=_bool, default=True,
        help="Log to wandb when available (JSONL always)")
    add("--log_every", type=int, default=5, help="Metric logging cadence in steps")
    add("--eval_batches", type=int, default=2,
        help="Eval on one fixed clip batch when above 0")
    add("--evaluate_every_n_steps", type=int, default=250,
        help="Eval and checkpoint cadence (0 = final save only)")
    add("--ckpt_dir", type=str, default="./ckpt", help="Checkpoint root directory")
    add("--load_path", type=str, default=None,
        help="Reference-format .pt to start G from; otherwise the run dir's latest full "
             "state resumes")
    add("--seed", type=int, default=42, help="Seed")
    add("--device", type=str, default="cuda",
        help="Device to train on: cuda (default; raises without a card; under torchrun "
             "cuda:LOCAL_RANK) or cpu (gloo between ranks)")
    return p


def configs_3d(kw: dict) -> tuple[TrainConfig, TVAEConfig]:
    """The configs a parsed ``train3d`` flag set describes, built as the JAX
    CLI builds them."""
    tvae_cfg = TVAEConfig(
        resolution=kw["vae_resolution"],
        ch=kw["vae_ch"],
        ch_mult=parse_ch_mult(kw["vae_ch_mult"]),
        num_res_blocks=kw["vae_num_res_blocks"],
        z_channels=kw["vae_z_channels"],
        reg_type=kw["reg_type"],
        vq_codebook_size=kw["vq_codebook_size"],
        vq_ema_decay=kw["vq_ema_decay"],
        vq_revive_threshold=kw["vq_revive_threshold"],
        remat=kw["remat"],
        remat_policy=kw["remat_policy"],
        conv3d_impl=kw["conv3d_impl"],
        attn_chunk=kw["attn_chunk"],
        attn_impl=kw["attn_impl"],
        upsample_impl=kw["upsample_impl"],
        fused_gn_swish=kw["fused_gn_swish"],
    )
    cfg = TrainConfig(
        batch_size=kw["batch_size"],
        dataset_url=kw["dataset_url"],
        test_dataset_url=kw["test_dataset_url"],
        synthetic_data=not kw["dataset_url"],
        num_workers=kw["num_workers"],
        learning_rate_vae=kw["learning_rate_vae"],
        do_ganloss=kw["do_ganloss"],
        disc_type=kw["disc_type"],
        use_lecam=kw["use_lecam"],
        learning_rate_disc=kw["learning_rate_disc"],
        video_loss_frames=kw["video_loss_frames"],
        disc_3d=kw["disc_3d"],
        ema_decay=kw["ema_decay"],
        grad_accum=kw["grad_accum"],
        max_steps=kw["max_steps"],
        run_name=kw["run_name"],
        mesh_shape=kw["mesh_shape"],
        use_wandb=kw["use_wandb"],
        log_every=kw["log_every"],
        eval_batches=kw["eval_batches"],
        evaluate_every_n_steps=kw["evaluate_every_n_steps"],
        ckpt_dir=kw["ckpt_dir"],
        load_path=kw["load_path"],
        seed=kw["seed"],
    )
    return cfg, tvae_cfg


def train3d(argv: Optional[Sequence[str]] = None):
    """Parse the train3d flags and run the job; returns the finished
    ``Trainer3D``."""
    from vqgan_tpu_torch.train.trainer3d import Trainer3D

    kw = vars(build_parser_3d().parse_args(argv))
    cfg, tvae_cfg = configs_3d(kw)
    trainer = Trainer3D(cfg, tvae_cfg, frames=kw["frames"], device=kw["device"])
    trainer.train()
    return trainer


def main(argv: Optional[Sequence[str]] = None):
    """``[train] [flags]`` runs ``train``, ``train3d [flags]`` runs
    ``train3d``; each returns its finished trainer."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train3d":
        return train3d(argv[1:])
    if argv and argv[0] == "train":
        argv = argv[1:]
    return train(argv)


if __name__ == "__main__":
    main()
