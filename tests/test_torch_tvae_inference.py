"""The clip-serving slice as a whole: the JAX package's TVAEPipeline and the
port's load the same reference-format .pt (written by the JAX package's
``save_torch_checkpoint``) and must agree, on the CPU; and the ``--clips``
CLI.

Both sides run ``conv3d_impl="auto"``, which is the direct Conv3d off the
card (XLA's on the JAX side, the port's ``F.conv3d`` on a CPU tensor).
Weights are the JAX init's shapes filled with numpy (every residual branch
and GroupNorm affine active).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.inference import TVAEPipeline as JaxTVAEPipeline
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.train.torch_import import save_torch_checkpoint
from vqgan_tpu_torch.config import TVAEConfig
from vqgan_tpu_torch.inference import TVAEPipeline, _main, build_tvae_config

from torch_parity import randomize_params

# fp32 compute: XLA's and oneDNN's convs sum in other orders; latents are
# O(1) and decoded clips lie in [0, 1] (test_torch_tae.py's ATOL_NET)
ATOL_FP32 = 5e-5
# the default bf16 compute: test_torch_tae.py::test_bf16_compute_dtype's
# bounds for two bf16 decoders on the same latents, halved for the [0, 1]
# range (x·0.5 + 0.5)
MAX_BF16 = 0.05
MEAN_BF16 = 0.0075
TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8)


def _params(seed, **kw):
    model = JaxTVAE(cfg=JaxTVAEConfig(**TINY, **kw))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(seed),
                                         "sample": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, 4, 16, 16, 3)))
    return randomize_params(shapes["params"], seed)


def _clips(n, seed=0, frames=4):
    return np.random.RandomState(seed).randint(0, 256, (n, frames, 16, 16, 3), np.uint8)


@pytest.mark.parametrize("dtype,max_err,mean_err", [
    ("float32", ATOL_FP32, ATOL_FP32), ("bfloat16", MAX_BF16, MEAN_BF16),
], ids=["fp32", "bf16"])
def test_pipeline_matches_jax(tmp_path, dtype, max_err, mean_err):
    path = str(tmp_path / "tvae.pt")
    save_torch_checkpoint(_params(0), path)
    kw = dict(TINY, compute_dtype=dtype)
    jax_pipe = JaxTVAEPipeline.from_checkpoint(path, JaxTVAEConfig(**kw))
    port = TVAEPipeline.from_checkpoint(path, TVAEConfig(**kw), device="cpu")
    clips = _clips(2)
    z_ref = np.asarray(jax_pipe.encode(clips).astype(jnp.float32))
    z = port.encode(clips)
    assert z.shape == (2, 2, 8, 8, 8) and z.dtype == getattr(torch, dtype)
    err = np.abs(z.float().numpy() - z_ref)
    # latents are unclamped posterior means, O(1): the bf16 bounds apply in
    # the decoder's units before its [0, 1] mapping, so twice the image bound
    assert err.max() <= 2 * max_err and err.mean() <= 2 * mean_err, (err.max(), err.mean())
    # both decoders get the same latents, so the decode is compared alone
    z_in = jnp.asarray(z_ref).astype(getattr(jnp, dtype))
    dec = port.decode(torch.from_numpy(z_ref.copy()).to(getattr(torch, dtype)))
    assert dec.shape == (2, 4, 16, 16, 3) and dec.dtype == np.float32
    assert dec.min() >= 0.0 and dec.max() <= 1.0
    for got, ref in ((dec, jax_pipe.decode(z_in)),
                     (port.reconstruct(clips), jax_pipe.reconstruct(clips))):
        err = np.abs(got - ref)
        assert err.max() <= max_err and err.mean() <= mean_err, (err.max(), err.mean())


def test_latents_are_not_clamped_and_one_clip_is_batched(tmp_path):
    """No clamp (the JAX TVAEPipeline has none, unlike VAEPipeline); a single
    (T, H, W, 3) clip gains a batch dimension; a float clip in [-1, 1] skips
    the uint8 mapping."""
    params = _params(1)
    params["encoder"]["conv_out"]["kernel"] *= 50.0
    path = str(tmp_path / "big.pt")
    save_torch_checkpoint(params, path)
    cfg = TVAEConfig(**TINY, compute_dtype="float32")
    port = TVAEPipeline.from_checkpoint(path, cfg, device="cpu")
    clips = _clips(2, seed=1)
    z = port.encode(clips)
    assert float(z.abs().max()) > 8.0
    one = port.encode(clips[0])
    assert one.shape == (1, 2, 8, 8, 8)
    # oneDNN picks its conv algorithm by batch size: a few ulps of |z|
    torch.testing.assert_close(one[0], z[0], atol=1e-3, rtol=1e-5)
    floats = clips.astype(np.float32) / 127.5 - 1.0
    torch.testing.assert_close(port.encode(floats), z, rtol=0, atol=0)


def test_vq_pipeline_matches_jax(tmp_path):
    """A VQ TVAE checkpoint (``reg.codebook`` beside the convs) served by the
    port, against the JAX pipeline on the same params (the JAX package's
    own ``.pt`` reader drops ``reg.codebook``, ROADMAP.md Queue 3). The
    latents are codebook rows on both sides and the same rows for these
    seeds, whose encoder outputs keep clear of near-ties."""
    vq = dict(reg_type="vq", vq_codebook_size=256, vq_ema_decay=0.0, compute_dtype="float32")
    params = _params(2, **vq)
    path = str(tmp_path / "vq.pt")
    save_torch_checkpoint(params, path)
    jax_pipe = JaxTVAEPipeline(JaxTVAEConfig(**TINY, **vq),
                               jax.tree_util.tree_map(jnp.asarray, params))
    port = TVAEPipeline.from_checkpoint(path, TVAEConfig(**TINY, **vq), device="cpu")
    clips = _clips(1, seed=2)
    z = port.encode(clips)
    z_ref = np.asarray(jax_pipe.encode(clips))
    cb = port.model.reg.codebook.detach().numpy()
    d = ((z.numpy().reshape(-1, 1, 8) - cb[None]) ** 2).sum(-1)
    assert d.min(-1).max() <= 1e-10  # each latent is a codebook row
    np.testing.assert_allclose(z.numpy(), z_ref, atol=ATOL_FP32)
    np.testing.assert_allclose(port.reconstruct(clips), jax_pipe.reconstruct(clips),
                               atol=ATOL_FP32)


def test_build_tvae_config_matches_the_jax_cli():
    """The JAX ``--clips`` CLI's TVAEConfig (``inference.py:251-262``) from
    the same flags."""
    kw = dict(vae_resolution=128, vae_ch=64, vae_ch_mult="1,2,4", vae_num_res_blocks=2,
              vae_z_channels=16, reg_type="identity_gaussian", vq_codebook_size=1024)
    ours = dataclasses.asdict(build_tvae_config(kw, attn_chunk=1024))
    theirs = dataclasses.asdict(JaxTVAEConfig(
        resolution=128, ch=64, ch_mult=(1, 2, 4), num_res_blocks=2, z_channels=16,
        reg_type="gaussian", vq_codebook_size=1024, vq_ema_decay=0.0, attn_chunk=1024))
    assert ours == theirs
    assert build_tvae_config(dict(kw, reg_type="vq")).reg_type == "vq"


def test_cli_reconstructs_clips(tmp_path):
    path = str(tmp_path / "tvae.pt")
    save_torch_checkpoint(_params(3), path)
    clip = _clips(1, seed=3)[0]
    clip_path = str(tmp_path / "a.npy")
    np.save(clip_path, clip)
    flags = ["--checkpoint", path, "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
             "--vae_num_res_blocks", "1", "--vae_z_channels", "8", "--vae_resolution", "16",
             "--reg_type", "gaussian", "--out_dir", str(tmp_path / "out")]
    _main(flags + ["--clips", clip_path])
    out = np.load(tmp_path / "out" / "a_recon.npy")
    assert out.shape == (4, 16, 16, 3) and out.dtype == np.uint8
    cfg = TVAEConfig(**TINY)  # the CLI's: bf16 compute, attn_chunk 0
    want = TVAEPipeline.from_checkpoint(path, cfg, device="cpu").reconstruct(clip)[0]
    np.testing.assert_array_equal(out, (want * 255).astype(np.uint8))
    bad = str(tmp_path / "f.npy")
    np.save(bad, clip.astype(np.float32) / 255.0)
    with pytest.raises(SystemExit):  # a float clip is refused, not cast
        _main(flags + ["--clips", bad])
    np.save(bad, clip[..., :2])
    with pytest.raises(SystemExit):
        _main(flags + ["--clips", bad])
    assert not (tmp_path / "out" / "f_recon.npy").exists()
