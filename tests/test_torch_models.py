"""The port's 2D blocks, Encoder and Decoder against the flax modules, on the
CPU.

The JAX side runs with ``pallas_gn=True``, so every GroupNorm goes through the
Pallas kernel in interpret mode; the port's GroupNorm takes its plain version
on CPU tensors. Params come from the flax init, made non-trivial with numpy
(every residual branch and GroupNorm affine active), and reach the port
through ``jax_params_to_state_dict`` and ``load_state_dict(strict=True)``.
Layouts: the flax modules take NHWC, the port's modules (B, C, H, W)
channels_last; an NHWC array seen through ``permute(0, 3, 1, 2)`` is exactly
that, with no copy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.models import ae as jae
from vqgan_tpu.models import blocks as jblocks
from vqgan_tpu_torch.config import DTYPES, VAEConfig
from vqgan_tpu_torch.models import ae, blocks
from vqgan_tpu_torch.weights import jax_params_to_state_dict

from torch_parity import randomize_params

# fp32 on both sides; XLA's and oneDNN's convs and the two GroupNorms sum in
# other orders. Measured: 1.7e-6 for a block, 2.4e-6 for the encoder and
# 6.5e-6 for the HR decoder, on values up to |5|; the bounds leave ~6-8x.
ATOL_BLOCK = 1e-5
ATOL_NET = 5e-5


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def run_both(jax_module, torch_module, x, seed=0):
    variables = jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    params = randomize_params(variables["params"], seed)
    ref = np.asarray(jax_module.apply({"params": params}, jnp.asarray(x)))
    torch_module.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = torch_module(_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    return _nhwc(got), ref


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)], ids=["same", "wider"])
def test_resnet_block(cin, cout):
    got, ref = run_both(
        jblocks.ResnetBlock(cout, dtype=jnp.float32, pallas_gn=True),
        blocks.ResnetBlock(cin, cout, torch.float32),
        _x((2, 8, 8, cin)),
    )
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


def test_downsample_pads_asymmetrically():
    got, ref = run_both(jblocks.Downsample(dtype=jnp.float32),
                        blocks.Downsample(32, torch.float32), _x((2, 8, 10, 32)))
    assert got.shape == (2, 4, 5, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


def test_upsample_direct():
    got, ref = run_both(jblocks.Upsample(dtype=jnp.float32, impl="direct"),
                        blocks.Upsample(32, torch.float32), _x((2, 4, 6, 32)))
    assert got.shape == (2, 8, 12, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


def test_nearest_upsample_matches_jax():
    from vqgan_tpu.ops.resize import nearest_upsample_2x as jax_up
    from vqgan_tpu_torch.ops.resize import nearest_upsample_2x

    x = _x((2, 3, 5, 8))
    got = _nhwc(nearest_upsample_2x(_nchw(x)))
    np.testing.assert_array_equal(got, np.asarray(jax_up(jnp.asarray(x))))


def test_swish_matches_jax():
    x = _x((4, 64))
    np.testing.assert_allclose(blocks.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jblocks.swish(jnp.asarray(x))),
                               atol=1e-6)


TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
            z_channels=8, enc_dtype="float32", dec_dtype="float32")


@pytest.mark.parametrize("double_z", [False, True], ids=["plain", "gaussian"])
def test_encoder(double_z):
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
              double_z=double_z)
    got, ref = run_both(
        jae.Encoder(**kw, dtype=jnp.float32, pallas_gn=True),
        ae.Encoder(**kw, dtype=torch.float32),
        _x((2, 32, 32, 3)),
    )
    assert got.shape == (2, 16, 16, 16 if double_z else 8)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


@pytest.mark.parametrize("hr", [False, True], ids=["plain", "hr"])
def test_decoder(hr):
    cfg = VAEConfig(**TINY, decoder_also_perform_hr=hr)
    assert cfg.decoder_ch_mult == JaxVAEConfig(
        **TINY, decoder_also_perform_hr=hr).decoder_ch_mult
    got, ref = run_both(
        jae.Decoder(ch=32, out_ch=3, ch_mult=cfg.decoder_ch_mult,
                    num_res_blocks=1, dtype=jnp.float32, pallas_gn=True,
                    upsample_impl="direct"),
        ae.Decoder(32, 3, cfg.decoder_ch_mult, 1, z_channels=8,
                   dtype=torch.float32),
        _x((2, 16, 16, 8)),
    )
    assert got.shape == ((2, 64, 64, 3) if hr else (2, 32, 32, 3))
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


def test_config_has_every_jax_field_with_its_default():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxVAEConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(VAEConfig)}
    assert port_fields == jax_fields
    for kw in ({}, {"use_wavelet": True}, {"decoder_also_perform_hr": True},
               {"ch_mult": (1, 2, 4), "use_wavelet": True,
                "decoder_also_perform_hr": True}):
        j, p = JaxVAEConfig(**kw), VAEConfig(**kw)
        assert p.decoder_ch_mult == j.decoder_ch_mult
        assert p.ffactor == j.ffactor
    assert DTYPES[VAEConfig().enc_dtype] == torch.float32
    assert DTYPES[VAEConfig().dec_dtype] == torch.bfloat16


@pytest.mark.parametrize("kw,conv_in,z_side", [
    ({"use_wavelet": True}, (64, 12, 3, 3), 16),
    ({"use_wavelet": True, "ch_mult": (1, 2, 4)}, (64, 12, 3, 3), 8),
])
def test_wavelet_model_builds_and_runs(kw, conv_in, z_side):
    """The wavelet front end (JAX ae.py:114-131): conv_in takes the 4·3
    wavelet channels to 2·ch; level 0 keeps its resolution, so the latent
    side is the resolution over 2^(levels - 1) as without it
    (tests/test_torch_wavelet.py holds it against JAX)."""
    model = ae.init_vae(VAEConfig(**{**TINY, **kw}), torch.Generator().manual_seed(0))
    assert tuple(model.encoder.conv_in.weight.shape) == conv_in
    assert model.encoder.down[0].downsample is None
    with torch.no_grad():
        z = model.encode(torch.from_numpy(_x((1, 32, 32, 3))))
        dec = model.decode(z)
    assert z.shape == (1, z_side, z_side, 8) and dec.shape == (1, 32, 32, 3)
    assert torch.isfinite(dec.float()).all()


def test_vae_dtype_policy():
    """Encoder convs compute in enc_dtype, decoder convs in dec_dtype; params
    stay fp32; GroupNorm returns its input's dtype."""
    model = ae.init_vae(VAEConfig(**dict(TINY, dec_dtype="bfloat16")),
                        torch.Generator().manual_seed(0))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        z = model.encode(torch.from_numpy(_x((1, 32, 32, 3))))
        dec = model.decode(z)
    assert z.dtype == torch.float32 and dec.dtype == torch.bfloat16
    assert z.shape == (1, 16, 16, 8) and dec.shape == (1, 32, 32, 3)
