"""The port's 3D video VAE modules against the flax modules of
``vqgan_tpu/models/tae.py``, on the CPU.

Params come from the flax init, made non-trivial with numpy, and reach the
port through ``jax_params_to_state_dict`` (Conv3d kernels DHWIO → OIDHW) and
``load_state_dict(strict=True)``. Layouts: the flax modules take NDHWC, the
port's modules (B, C, T, H, W) channels_last_3d; an NDHWC array seen through
``permute(0, 4, 1, 2, 3)`` is exactly that, with no copy. The JAX side runs
``conv3d_impl="direct"`` (XLA's Conv3d) except where a test says
``"pallas"`` (the fused-tap kernel in interpret mode, slow on the CPU); the
port's CPU tensors take the plain Conv3d either way.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.models import tae as jtae
from vqgan_tpu_torch.config import TVAEConfig
from vqgan_tpu_torch.models import tae
from vqgan_tpu_torch.weights import jax_params_to_state_dict

from torch_parity import randomize_params

# fp32 on both sides; XLA's and oneDNN's convs and the two GroupNorms sum in
# other orders (the 2D bounds of test_torch_models.py; measured here: up to
# 1.2e-6 for a block and 4.1e-6 for the encoder or decoder on values up to |6|)
ATOL_BLOCK = 1e-5
ATOL_NET = 5e-5
TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            compute_dtype="float32")


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def run_both(jax_module, torch_module, x, seed=0):
    # the params' shapes only (tracing, no op-by-op init), then numpy values
    variables = jax.eval_shape(jax_module.init, jax.random.PRNGKey(seed), jnp.asarray(x))
    params = randomize_params(variables["params"], seed)
    ref = np.asarray(jax_module.apply({"params": params}, jnp.asarray(x)))
    torch_module.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = torch_module(tae.ncdhw(torch.from_numpy(x)))
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    return got.permute(0, 2, 3, 4, 1).numpy(), ref


@pytest.mark.parametrize("fused_swish", [False, True], ids=["silu", "fused_swish"])
@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)], ids=["same", "wider"])
def test_resnet_block(cin, cout, fused_swish):
    got, ref = run_both(
        jtae.ResnetBlock3D(cout, dtype=jnp.float32, fused_swish=fused_swish),
        tae.ResnetBlock3D(cin, cout, torch.float32, fused_swish=fused_swish),
        _x((2, 3, 6, 6, cin)),
    )
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


@pytest.mark.parametrize("attn_chunk", [0, 8], ids=["dense", "chunked"])
def test_attn_block(attn_chunk):
    """(2, 2, 4, 4, 64): 32 tokens, 8 heads of 8; a chunk of 8 divides 32."""
    got, ref = run_both(
        jtae.AttnBlock3D(dtype=jnp.float32, attn_chunk=attn_chunk),
        tae.AttnBlock3D(64, torch.float32, attn_chunk=attn_chunk),
        _x((2, 2, 4, 4, 64)),
    )
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


def test_attn_block_splits_thirds_then_eight_heads():
    """q, k, v are the qkv conv's channel thirds, each cut into 8 heads: with
    v = the input and q = k = 0 every token's output is the mean of the
    values, the same for every head split; with q = k = the input and one
    token per head group the output is the token's own value only if the
    heads are cut from thirds, not interleaved."""
    c = 64
    block = tae.AttnBlock3D(c, torch.float32)
    with torch.no_grad():
        w = torch.zeros(3 * c, c, 1, 1, 1)
        w[2 * c:, :, 0, 0, 0] = torch.eye(c)  # v = the normalized input
        block.qkv.weight.copy_(w)
        block.proj_out.weight.copy_(torch.eye(c)[:, :, None, None, None])
        block.norm.weight.fill_(1.0)
        block.norm.bias.zero_()
    x = tae.ncdhw(torch.from_numpy(_x((1, 1, 1, 1, c))))  # one token
    with torch.no_grad():
        torch.testing.assert_close(block(x), x + block.norm(x))


def test_attn_chunk_must_divide_the_token_count():
    block = tae.AttnBlock3D(64, torch.float32, attn_chunk=12)
    with pytest.raises(ValueError, match="attn_chunk 12 must divide"):
        block(tae.ncdhw(torch.zeros(1, 2, 4, 4, 64)))


def test_downsample_pads_asymmetrically():
    got, ref = run_both(jtae.Downsample3D(dtype=jnp.float32),
                        tae.Downsample3D(32, torch.float32), _x((2, 5, 8, 6, 32)))
    assert got.shape == (2, 2, 4, 3, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


@pytest.mark.parametrize("impl", ["direct", "pallas"])
def test_upsample(impl):
    """"pallas" on both sides: the JAX kernel in interpret mode, the port's
    plain version."""
    got, ref = run_both(
        jtae.Upsample3D(dtype=jnp.float32, conv3d_impl=impl, upsample_impl="direct"),
        tae.Upsample3D(32, torch.float32, conv3d_impl=impl), _x((1, 2, 3, 4, 32)))
    assert got.shape == (1, 4, 6, 8, 32)
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


@pytest.mark.parametrize("fused_swish", [False, True], ids=["silu", "fused_swish"])
def test_encoder(fused_swish):
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8)
    got, ref = run_both(
        jtae.Encoder3D(**kw, dtype=jnp.float32, fused_swish=fused_swish),
        tae.Encoder3D(**kw, dtype=torch.float32, fused_swish=fused_swish),
        _x((2, 4, 16, 16, 3)),
    )
    assert got.shape == (2, 2, 8, 8, 16)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


@pytest.mark.parametrize("fused_swish", [False, True], ids=["silu", "fused_swish"])
def test_decoder(fused_swish):
    got, ref = run_both(
        jtae.Decoder3D(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, dtype=jnp.float32,
                       fused_swish=fused_swish, upsample_impl="direct"),
        tae.Decoder3D(32, 3, (1, 2), 1, z_channels=8, dtype=torch.float32,
                      fused_swish=fused_swish),
        _x((2, 2, 8, 8, 8)),
    )
    assert got.shape == (2, 4, 16, 16, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


def jax_tvae_params(cfg_kw, seed):
    model = jtae.TVAE(cfg=JaxTVAEConfig(**cfg_kw))
    x = jnp.zeros((1, 4, cfg_kw["resolution"], cfg_kw["resolution"], 3))
    variables = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(seed),
                                            "sample": jax.random.PRNGKey(seed + 1)}, x)
    return randomize_params(variables["params"], seed)


def _jax_reconstruct(cfg_kw, params, x):
    model = jtae.TVAE(cfg=JaxTVAEConfig(**cfg_kw))

    @jax.jit
    def run(p, x_):
        z = model.apply({"params": p}, x_, method=model.encode)
        lat = model.apply({"params": p}, z, method=model.deterministic_latent)
        return z, lat, model.apply({"params": p}, lat, method=model.decode)

    return tuple(np.asarray(a) for a in run(params, jnp.asarray(x)))


@pytest.mark.parametrize("reg_type,impl,attn_chunk,frames", [
    ("gaussian", "direct", 0, 4), ("gaussian", "pallas", 0, 2), ("gaussian", "direct", 32, 4),
    ("vq", "direct", 0, 4),
], ids=["gaussian", "gaussian-pallas", "gaussian-chunked", "vq"])
def test_tvae_matches_jax(reg_type, impl, attn_chunk, frames):
    """encode → deterministic_latent → decode, the serving path, from the
    same params; with 4 frames the mid block has 2·8·8 = 128 tokens of 64
    channels (2 frames, 1 mid-block frame, where interpret mode is slow)."""
    kw = dict(TINY, reg_type=reg_type, conv3d_impl=impl, attn_chunk=attn_chunk)
    if reg_type == "vq":
        kw.update(vq_codebook_size=256, vq_ema_decay=0.0)
    params = jax_tvae_params(kw, seed=3)
    x = _x((1, frames, 16, 16, 3), seed=4)
    z_ref, lat_ref, dec_ref = _jax_reconstruct(kw, params, x)
    model = tae.TVAE(TVAEConfig(**kw))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        z = model.encode(torch.from_numpy(x))
        np.testing.assert_allclose(z.numpy(), z_ref, atol=ATOL_NET)
        lat = model.deterministic_latent(z)
        assert lat.shape == (1, frames // 2, 8, 8, 8)
        if reg_type == "vq":
            # each latent is a codebook row; the rows agree where the two
            # searches see z within ATOL_NET, which these seeds keep clear
            # of near-ties
            cb = model.reg.codebook.numpy()
            rows = ((lat.numpy().reshape(-1, 1, 8) - cb[None]) ** 2).sum(-1).min(-1)
            assert rows.max() <= 1e-10
        np.testing.assert_allclose(lat.numpy(), lat_ref, atol=ATOL_NET)
        # both decoders get the JAX latents, so the decode is compared alone
        dec = model.decode(torch.from_numpy(lat_ref.copy()))
    np.testing.assert_allclose(dec.numpy(), dec_ref, atol=ATOL_NET)


def test_bf16_compute_dtype():
    """The default bf16 policy: the encoder output stays bf16 and the
    posterior mean is split in fp32 then cast back, as in JAX. Each side
    rounds every conv output to bf16 after sums in other orders (and adds
    the direct conv's bias before or after that rounding). On these weights
    the port's bf16 decoder is 0.042 max and 0.0062 mean from its fp32
    decoder (JAX's: 0.053, 0.0073) on values up to |3.3|, so two bf16
    decoders may differ by about twice that (measured: 0.070 and 0.0085)."""
    kw = dict(TINY, compute_dtype="bfloat16")
    params = jax_tvae_params(kw, seed=5)
    x = _x((1, 4, 16, 16, 3), seed=6)
    _, lat_ref, dec_ref = _jax_reconstruct(kw, params, x)
    model = tae.TVAE(TVAEConfig(**kw))
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        lat = model.deterministic_latent(model.encode(torch.from_numpy(x)))
        dec = model.decode(torch.from_numpy(lat_ref.astype(np.float32)).bfloat16())
    assert lat.dtype == torch.bfloat16 and dec.dtype == torch.bfloat16
    err = np.abs(dec.float().numpy() - dec_ref.astype(np.float32))
    assert err.max() <= 0.1 and err.mean() <= 0.015, (err.max(), err.mean())
    lat_err = np.abs(lat.float().numpy() - lat_ref.astype(np.float32))
    assert lat_err.max() <= 0.1 and lat_err.mean() <= 0.015, (lat_err.max(), lat_err.mean())


def test_init_scheme():
    """torch's default Conv3d init with biases NOT zeroed (reference
    tae.py:57-90), proj_out normal with std 0.2/√C, GroupNorm 1 and 0."""
    cfg = TVAEConfig(**dict(TINY, ch=64, ch_mult=(1, 2)))
    model = tae.init_tvae(cfg, torch.Generator().manual_seed(0))
    same = tae.init_tvae(cfg, torch.Generator().manual_seed(0))
    for (k, a), (_, b) in zip(model.state_dict().items(), same.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    for name, m in model.named_modules():
        if not isinstance(m, tae.Conv3d):
            continue
        w = m.weight.detach()
        bound = 1 / math.sqrt(w[0].numel())
        if name.endswith("proj_out"):
            assert abs(float(w.std()) / (0.2 / math.sqrt(w.shape[0])) - 1) < 0.05
            continue
        assert float(w.abs().max()) <= bound
        if w.numel() > 4096:
            assert abs(float(w.std()) / (bound / math.sqrt(3)) - 1) < 0.1, name
        if m.bias is not None:
            b = m.bias.detach().abs()
            assert float(b.max()) <= bound and float(b.max()) > 0, name
    attn = model.encoder.mid.attn_1
    assert attn.qkv.bias is None and attn.proj_out.bias is None


def test_conv3d_impl_resolution():
    """"pallas" and "auto" on a CUDA tensor take the kernel route, "mixed"
    only where min(Ci, Co) >= 128, the others and the stride-2 conv F.conv3d;
    an unknown value raises, as in JAX."""
    x = torch.zeros(1, 1, 1, 1, 1)
    for impl, ci, want in [("pallas", 8, True), ("auto", 8, False), ("direct", 8, False),
                           ("tap2d", 8, False), ("tap2dfat", 8, False),
                           ("mixed", 64, False), ("mixed", 128, True)]:
        assert tae.Conv3d(ci, 128, 3, padding=1, impl=impl).uses_kernel(x) == want, impl
    assert not tae.Conv3d(8, 8, 3, stride=2, impl="pallas").uses_kernel(x)
    assert not tae.Conv3d(8, 8, 1, impl="pallas").uses_kernel(x)
    with pytest.raises(ValueError, match="conv3d_impl"):
        tae.TVAE(TVAEConfig(**dict(TINY, conv3d_impl="fat")))
    # a context group reaches every conv, GroupNorm, downsample and attention
    # block; the parameter tree is the one without
    model = tae.TVAE(TVAEConfig(**TINY), context="group")
    assert all(m.context == "group" for m in model.modules()
               if isinstance(m, (tae.Conv3d, tae.FP32GroupNorm, tae.Downsample3D,
                                 tae.AttnBlock3D)))
    assert list(model.state_dict()) == list(tae.TVAE(TVAEConfig(**TINY)).state_dict())


def test_tvae_weights_load_strictly():
    """The JAX TVAE tree (mid_attn_1, down_i/downsample, up_i/upsample,
    reg/codebook) maps to the port's module names with OIDHW kernels."""
    kw = dict(TINY, reg_type="vq", vq_codebook_size=64)
    params = jax_tvae_params(kw, seed=0)
    sd = jax_params_to_state_dict(params)
    model = tae.TVAE(TVAEConfig(**kw))
    model.load_state_dict(sd, strict=True)
    assert sd["encoder.conv_in.weight"].shape == (32, 3, 3, 3, 3)
    assert sd["encoder.mid.attn_1.qkv.weight"].shape == (192, 64, 1, 1, 1)
    assert sd["encoder.down.0.downsample.conv.weight"].shape == (32, 32, 3, 3, 3)
    assert sd["decoder.up.1.upsample.conv.bias"].shape == (64,)
    assert sd["reg.codebook"].shape == (64, 8)
    k = params["encoder"]["down_0"]["block_0"]["conv1"]["kernel"]  # DHWIO
    np.testing.assert_array_equal(sd["encoder.down.0.block.0.conv1.weight"][5, 7].numpy(),
                                  k[:, :, :, 7, 5])


def test_forward_quantizes_vq():
    kw = dict(TINY, reg_type="vq", vq_codebook_size=64, vq_ema_decay=0.0)
    model = tae.init_tvae(TVAEConfig(**kw), torch.Generator().manual_seed(1))
    x = torch.from_numpy(_x((1, 4, 16, 16, 3)))
    with torch.no_grad():
        dec, z = model(x)
        assert dec.shape == (1, 4, 16, 16, 3) and z.shape == (1, 2, 8, 8, 8)
        torch.testing.assert_close(dec, model.decode(model.deterministic_latent(z)))
    gauss = tae.init_tvae(TVAEConfig(**TINY), torch.Generator().manual_seed(1))
    with torch.no_grad():  # the Gaussian samples: mean + exp(max(logvar, -3)/2)·ε
        torch.manual_seed(3)
        dec, z = gauss(x)
        mean, logvar = z.chunk(2, dim=-1)
        torch.manual_seed(3)
        eps = torch.randn(mean.shape)
        z_s = mean + torch.exp(0.5 * logvar.clamp(min=-3.0)) * eps
        torch.testing.assert_close(dec, gauss.decode(z_s))
        assert not torch.allclose(dec, gauss.decode(gauss.deterministic_latent(z)))
