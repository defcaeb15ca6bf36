"""The serving slice as a whole: the JAX package's VAEPipeline and the port's
VAEPipeline load the same reference-format .pt and must agree, on the CPU.

The JAX side runs with ``use_pallas_gn=True``, so its 50-call GroupNorm path
is the Pallas kernel (interpret mode); the port's CPU tensors take the plain
GroupNorm. Weights are the JAX init made non-trivial with numpy (every
residual branch and GroupNorm affine active), written by
``vqgan_tpu.train.checkpoint.save_weights_torch``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.inference import VAEPipeline as JaxPipeline
from vqgan_tpu.inference import build_vae_config as jax_build_vae_config
from vqgan_tpu.models.ae import init_vae_params
from vqgan_tpu.train.checkpoint import save_weights_torch
from vqgan_tpu_torch.config import VAEConfig
from vqgan_tpu_torch.inference import (
    VAEPipeline,
    _main,
    add_vae_arch_args,
    build_vae_config,
)

from torch_parity import distance_gap, randomize_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
            z_channels=8, enc_dtype="float32", dec_dtype="float32")

# fp32 encoder and decoder: XLA's and oneDNN's convs sum in other orders;
# latents are O(1) and the decoded images lie in [0, 1] (measured: 4.4e-6)
ATOL_FP32 = 5e-5
# bf16 decoder (the default policy): each conv output is rounded to bf16 on
# either side after sums in other orders. The port's bf16 decoder is 0.018
# max and 0.0024 mean from its fp32 decoder on these weights, so two bf16
# decoders may differ by twice that (measured: 0.024 max, 0.0031 mean)
MAX_BF16_DEC = 0.04
MEAN_BF16_DEC = 0.005


def _params(seed, reg_type, **cfg_kw):
    _, params = init_vae_params(JaxVAEConfig(**TINY, reg_type=reg_type, **cfg_kw),
                                jax.random.PRNGKey(seed))
    return randomize_params(jax.device_get(params), seed)


def _checkpoint(tmp_path, seed=0, reg_type="identity_gaussian", scale_z=1.0):
    params = _params(seed, reg_type)
    params["encoder"]["conv_out"]["kernel"] *= scale_z
    path = str(tmp_path / f"w{seed}_{reg_type}.pt")
    save_weights_torch(params, path)
    return path


def _pipelines(path, **cfg_kw):
    kw = dict(TINY, **cfg_kw)
    jax_pipe = JaxPipeline.from_checkpoint(
        path, JaxVAEConfig(**kw, use_pallas_gn=True))
    port = VAEPipeline.from_checkpoint(path, VAEConfig(**kw), device="cpu")
    return jax_pipe, port


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 32, 32, 3), np.uint8)


@pytest.mark.parametrize("dec_dtype,max_err,mean_err", [
    ("float32", ATOL_FP32, ATOL_FP32), ("bfloat16", MAX_BF16_DEC, MEAN_BF16_DEC),
], ids=["fp32", "bf16_dec"])
def test_pipeline_matches_jax(tmp_path, dec_dtype, max_err, mean_err):
    jax_pipe, port = _pipelines(_checkpoint(tmp_path), dec_dtype=dec_dtype)
    imgs = _images(2)
    z_ref = np.asarray(jax_pipe.encode(imgs))
    z = port.encode(imgs)
    assert z.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(z.numpy(), z_ref, atol=ATOL_FP32)  # fp32 encoder
    # both decoders get the same latents, so the decode is compared alone
    dec = port.decode(z_ref)
    assert dec.shape == (2, 32, 32, 3) and dec.dtype == np.float32
    assert dec.min() >= 0.0 and dec.max() <= 1.0
    for got, ref in ((dec, jax_pipe.decode(z_ref)),
                     (port.reconstruct(imgs), jax_pipe.reconstruct(imgs))):
        err = np.abs(got - ref)
        assert err.max() <= max_err and err.mean() <= mean_err, (err.max(), err.mean())


def test_clamp_and_single_and_float_images(tmp_path):
    """Latents clamp to ±8 as in JAX; an un-batched image is batched; a float
    image in [-1, 1] skips the uint8 mapping."""
    jax_pipe, port = _pipelines(_checkpoint(tmp_path, seed=1, scale_z=50.0))
    imgs = _images(2, seed=1)
    z = port.encode(imgs).numpy()
    assert float(np.abs(z).max()) == 8.0
    np.testing.assert_allclose(z, np.asarray(jax_pipe.encode(imgs)), atol=1e-3)
    one = port.encode(imgs[0]).numpy()
    assert one.shape == (1, 16, 16, 8)
    # oneDNN picks its conv algorithm by batch size: a few ulps of |z| <= 8
    np.testing.assert_allclose(one[0], z[0], atol=1e-3)
    floats = imgs.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(port.encode(floats).numpy(), z)


def test_gaussian_takes_the_mean(tmp_path):
    jax_pipe, port = _pipelines(_checkpoint(tmp_path, seed=2, reg_type="gaussian"),
                                reg_type="gaussian")
    imgs = _images(1, seed=2)
    z = port.encode(imgs).numpy()
    assert z.shape == (1, 16, 16, 8)
    np.testing.assert_allclose(z, np.asarray(jax_pipe.encode(imgs)), atol=ATOL_FP32)


def test_vq_pipeline_matches_jax(tmp_path):
    """A JAX VQ checkpoint (``reg.codebook`` beside the convs, written by
    ``save_weights_torch``) served by the port, against the JAX pipeline on
    the same params. (The JAX package's own ``.pt`` reader drops
    ``reg.codebook``, so its ``from_checkpoint`` refuses the file; it is
    given the params.) The latents are the nearest codebook rows on both
    sides, by distance: each side's encoder z is within ATOL_FP32 of the
    other's, so a code the two pick differently is at most fp32 rounding plus
    2·‖δz‖·‖E_a − E_b‖ farther from the port's z."""
    vq = dict(reg_type="vq", vq_codebook_size=1024, vq_ema_decay=0.0)
    params = _params(5, **vq)
    path = str(tmp_path / "vq.pt")
    save_weights_torch(params, path)
    jax_pipe = JaxPipeline(JaxVAEConfig(**TINY, **vq, use_pallas_gn=True),
                           jax.tree_util.tree_map(jax.numpy.asarray, params))
    port = VAEPipeline.from_checkpoint(path, VAEConfig(**TINY, **vq), device="cpu")
    imgs = _images(2, seed=5)
    z_ref = np.asarray(jax_pipe.encode(imgs)).reshape(-1, 8)
    z = port.encode(imgs)
    assert z.shape == (2, 16, 16, 8)
    cb = port.model.reg.codebook.detach().numpy()
    z_pre = port.model.encode(port._to_model_input(imgs)).clamp(-8, 8).detach().numpy()
    z_pre = z_pre.reshape(-1, 8)
    # each latent is its code's row up to the straight-through rounding
    # z + (e − z): a few ulps of max(|z|, |e|)
    codes, ref = (np.argmin(((lat[:, None] - cb[None]) ** 2).sum(-1), axis=1)
                  for lat in (z.numpy().reshape(-1, 8), z_ref))
    np.testing.assert_allclose(z.numpy().reshape(-1, 8), cb[codes], atol=1e-6)
    np.testing.assert_allclose(z_ref, cb[ref], atol=1e-6)
    gap, tol = distance_gap(z_pre, cb, codes, ref)
    shift = 2 * np.sqrt(8) * ATOL_FP32 * np.linalg.norm(cb[codes] - cb[ref], axis=-1)
    assert (gap <= tol + shift).all()
    assert (codes == ref).mean() >= 0.99
    # both decoders get the same latents
    np.testing.assert_allclose(port.decode(z_ref.reshape(2, 16, 16, 8)),
                               jax_pipe.decode(z_ref.reshape(2, 16, 16, 8)), atol=ATOL_FP32)
    rec = port.reconstruct(imgs)
    assert rec.shape == (2, 32, 32, 3) and rec.min() >= 0.0 and rec.max() <= 1.0


def test_vq_codebook_in_checkpoint_fails_loudly(tmp_path):
    import torch

    path = _checkpoint(tmp_path, seed=3)
    sd = torch.load(path, weights_only=True)
    sd["reg.codebook"] = torch.zeros(32, 8)
    torch.save(sd, path)
    with pytest.raises(ValueError, match="codebook"):
        VAEPipeline.from_checkpoint(path, VAEConfig(**TINY), device="cpu")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, vqgan_tpu_torch.inference, vqgan_tpu_torch.weights\n"
        "import vqgan_tpu_torch.train.step, vqgan_tpu_torch.train.state\n"
        "import vqgan_tpu_torch.losses.lpips, vqgan_tpu_torch.losses.discriminator\n"
        "import vqgan_tpu_torch.tools.profile_step, vqgan_tpu_torch.ops.gradnorm\n"
        "import vqgan_tpu_torch.models.quant, vqgan_tpu_torch.ops.vq\n"
        "import vqgan_tpu_torch.ops.vq_cuda, vqgan_tpu_torch.ops.attention_cuda\n"
        "import vqgan_tpu_torch.models.tae, vqgan_tpu_torch.ops.conv3d_cuda\n"
        "import vqgan_tpu_torch.tools.profile_serving\n"
        "import vqgan_tpu_torch.export, vqgan_tpu_torch.ops.custom_ops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'vqgan_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_vae_config_matches_jax_flags():
    import argparse

    parser = argparse.ArgumentParser()
    add_vae_arch_args(parser)
    for argv in ([], ["--vae_ch", "64", "--vae_ch_mult", "1,2,4",
                      "--decoder_also_perform_hr", "true", "--reg_type", "gaussian"],
                 ["--reg_type", "vq", "--vq_codebook_size", "1024"]):
        kw = vars(parser.parse_args(argv))
        ours = dataclasses.asdict(build_vae_config(kw))
        assert ours == dataclasses.asdict(jax_build_vae_config(kw))


def test_cli_reconstructs_images(tmp_path):
    from PIL import Image

    path = _checkpoint(tmp_path, seed=4)
    img_path = str(tmp_path / "a.png")
    Image.fromarray(_images(1, seed=4)[0]).save(img_path)
    flags = ["--checkpoint", path, "--device", "cpu", "--vae_ch", "32",
             "--vae_ch_mult", "1,2", "--vae_num_res_blocks", "1",
             "--vae_z_channels", "8", "--vae_resolution", "32",
             "--out_dir", str(tmp_path / "out")]
    _main(flags + ["--images", img_path])
    out = np.asarray(Image.open(tmp_path / "out" / "a_recon.png"))
    assert out.shape == (32, 32, 3) and out.dtype == np.uint8
    with pytest.raises(SystemExit):  # both --images and --clips
        _main(flags + ["--images", img_path, "--clips", "a.npy"])
    with pytest.raises(SystemExit):
        _main(flags)
