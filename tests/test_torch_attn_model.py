"""The mid-block attention through the port's model, pipeline and training
step, against the JAX package, on the CPU.

The JAX side runs ``use_pallas_gn=True`` where its module takes it (every
ResnetBlock and ``norm_out`` GroupNorm through the Pallas kernel in
interpret mode; its AttnBlock norm is the XLA form) and, with
``attn_chunk`` > 0, the chunked lax attention (the "auto" choice off the
TPU). The port's CPU tensors take the plain GroupNorm and the chunked plain
attention. Params are the flax init made non-trivial with numpy, loaded
strictly through ``jax_params_to_state_dict``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.inference import VAEPipeline as JaxPipeline
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models import ae as jae
from vqgan_tpu.models import blocks as jblocks
from vqgan_tpu.models.ae import init_vae_params
from vqgan_tpu.train.checkpoint import save_weights_torch
from vqgan_tpu.train.state import create_train_state as jax_create_train_state
from vqgan_tpu.train.step import make_train_step as jax_make_train_step
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.inference import VAEPipeline
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.models import ae, blocks
from vqgan_tpu_torch.train.state import create_train_state
from vqgan_tpu_torch.train.step import make_train_step
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
)

from test_torch_models import run_both
from test_torch_train_step import GRAD_RTOL, ZERO_FLOOR, _check_tensors, _jax_draws, _mu_tree
from torch_parity import randomize_params

# fp32 on both sides; XLA's and oneDNN's convs and matmuls sum in other
# orders (test_torch_models.py's bounds; measured, dense and chunked: up to
# 8.9e-7 for the block on values up to |4.3|, 3.1e-6 for the encoder and
# 3.5e-6 for the decoder with attention)
ATOL_BLOCK = 1e-5
ATOL_NET = 5e-5
# the mid block at 32 px with ch=32, ch_mult (1, 2): 16x16 = 256 tokens of 64
# channels, one head of 64; a chunk of 64 takes the memory-efficient path
TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            enc_dtype="float32", dec_dtype="float32", use_attn=True)
CHUNKS = [0, 64]
CHUNK_IDS = ["dense", "chunked"]


def _x(shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("attn_chunk", [0, 16], ids=CHUNK_IDS)
def test_attn_block_matches_jax(attn_chunk):
    """(2, 8, 8, 128): 64 tokens, two heads of 64; a chunk of 16 divides 64."""
    got, ref = run_both(
        jblocks.AttnBlock(dtype=jnp.float32, attn_chunk=attn_chunk),
        blocks.AttnBlock(128, torch.float32, attn_chunk=attn_chunk),
        _x((2, 8, 8, 128)),
    )
    np.testing.assert_allclose(got, ref, atol=ATOL_BLOCK)


def test_attn_block_splits_thirds_then_heads():
    """q, k, v are the qkv conv's channel thirds, each cut into heads of 64:
    with identity-like weights that route v = the input, the attention of
    one token is its own value, so a wrong split ((heads, 3) instead of
    (3, heads)) would mix q/k channels into the output."""
    block = blocks.AttnBlock(128, torch.float32)
    c = 128
    with torch.no_grad():
        w = torch.zeros(3 * c, c, 1, 1)
        w[2 * c:, :, 0, 0] = torch.eye(c)  # v = x, q = k = 0: uniform weights
        block.qkv.weight.copy_(w)
        block.proj_out.weight.copy_(torch.eye(c)[:, :, None, None])
        block.norm.weight.fill_(1.0)
        block.norm.bias.zero_()
    x = blocks.nchw(torch.from_numpy(_x((1, 1, 1, c))))  # one token
    with torch.no_grad():
        y = block(x)
    hn = block.norm(x)
    torch.testing.assert_close(y, x + hn)


def test_attn_chunk_must_divide_the_token_count():
    block = blocks.AttnBlock(64, torch.float32, attn_chunk=48)
    with pytest.raises(ValueError, match="attn_chunk"):
        block(blocks.nchw(torch.zeros(1, 8, 8, 64)))


def test_attn_impl_keeps_the_jax_values():
    x = blocks.nchw(torch.from_numpy(_x((1, 8, 8, 64))))
    outs = []
    for impl in ("auto", "pallas", "lax"):
        block = blocks.AttnBlock(64, torch.float32, attn_chunk=16, attn_impl=impl)
        blocks.init_weights_(block, torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(block(x))
    assert all(torch.equal(o, outs[0]) for o in outs)
    block = blocks.AttnBlock(64, torch.float32, attn_chunk=16, attn_impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        block(x)


def test_attn_init_scheme():
    """proj_out normal with std 0.2/√C, qkv torch's default, no biases (the
    reference's init crashes on the bias-free convs; the port's does not)."""
    model = ae.init_vae(VAEConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                                  use_attn=True), torch.Generator().manual_seed(0))
    for side in (model.encoder, model.decoder):
        attn = side.mid.attn_1
        c = attn.proj_out.weight.shape[0]
        assert attn.qkv.bias is None and attn.proj_out.bias is None
        assert attn.qkv.weight.shape == (3 * c, c, 1, 1)
        assert abs(float(attn.proj_out.weight.detach().std()) / (0.2 / math.sqrt(c)) - 1) < 0.05
        bound = 1 / math.sqrt(c)
        qkv = attn.qkv.weight.detach()
        assert float(qkv.abs().max()) <= bound
        assert abs(float(qkv.std()) / (bound / math.sqrt(3)) - 1) < 0.05
        assert bool((attn.norm.weight == 1).all()) and bool((attn.norm.bias == 0).all())


@pytest.mark.parametrize("attn_chunk", CHUNKS, ids=CHUNK_IDS)
def test_encoder_with_attention(attn_chunk):
    kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8)
    got, ref = run_both(
        jae.Encoder(**kw, use_attn=True, attn_chunk=attn_chunk, dtype=jnp.float32,
                    pallas_gn=True),
        ae.Encoder(**kw, use_attn=True, attn_chunk=attn_chunk, dtype=torch.float32),
        _x((2, 32, 32, 3)),
    )
    assert got.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


@pytest.mark.parametrize("attn_chunk", CHUNKS, ids=CHUNK_IDS)
def test_decoder_with_attention(attn_chunk):
    got, ref = run_both(
        jae.Decoder(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, use_attn=True,
                    attn_chunk=attn_chunk, dtype=jnp.float32, pallas_gn=True,
                    upsample_impl="direct"),
        ae.Decoder(32, 3, (1, 2), 1, z_channels=8, use_attn=True, attn_chunk=attn_chunk,
                   dtype=torch.float32),
        _x((2, 16, 16, 8)),
    )
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL_NET)


def _params(seed, **kw):
    _, params = init_vae_params(JaxVAEConfig(**TINY, **kw), jax.random.PRNGKey(seed))
    return randomize_params(jax.device_get(params), seed)


def test_attention_weights_load_strictly():
    """The JAX params' ``mid_attn_1`` map to ``{encoder,decoder}.mid.attn_1``
    with no qkv or proj_out bias, and load into the port's VAE strictly."""
    sd = jax_params_to_state_dict(_params(0))
    attn_keys = {k for k in sd if ".attn_1." in k}
    assert attn_keys == {f"{side}.mid.attn_1.{name}" for side in ("encoder", "decoder")
                         for name in ("norm.weight", "norm.bias", "qkv.weight",
                                      "proj_out.weight")}
    model = ae.VAE(VAEConfig(**TINY))
    model.load_state_dict(sd, strict=True)
    assert model.encoder.mid.attn_1.qkv.weight.shape == (192, 64, 1, 1)


@pytest.mark.parametrize("attn_chunk", CHUNKS, ids=CHUNK_IDS)
def test_pipeline_with_attention_matches_jax(tmp_path, attn_chunk):
    """The JAX pipeline and the port's load the same reference-format .pt."""
    path = str(tmp_path / "attn.pt")
    save_weights_torch(_params(1), path)
    kw = dict(TINY, attn_chunk=attn_chunk)
    jax_pipe = JaxPipeline.from_checkpoint(path, JaxVAEConfig(**kw, use_pallas_gn=True))
    port = VAEPipeline.from_checkpoint(path, VAEConfig(**kw), device="cpu")
    imgs = np.random.RandomState(1).randint(0, 256, (2, 32, 32, 3), np.uint8)
    z_ref = np.asarray(jax_pipe.encode(imgs))
    np.testing.assert_allclose(port.encode(imgs).numpy(), z_ref, atol=ATOL_NET)
    # both decoders get the same latents; images lie in [0, 1]
    np.testing.assert_allclose(port.decode(z_ref), jax_pipe.decode(z_ref), atol=ATOL_NET)


@pytest.fixture(scope="module")
def step_runs():
    """One training step of each side from the same params, batch and draws
    (no flips), hinge + LeCam + clamp, fp32, D's lr 1e-8
    (tests/test_torch_train_step.py says why); returns the step-1 first
    moments and the metrics."""
    vae_kw = dict(TINY, attn_chunk=64)
    train = dict(batch_size=2, image_size=32, max_steps=10, warmup_steps=2,
                 learning_rate_vae=0.032, learning_rate_disc=1e-8, do_ganloss=True,
                 disc_type="hinge", use_lecam=True, do_clamp=True)
    x0 = jnp.zeros((1, 32, 32, 3))
    vae_cfg_j, cfg_j = JaxVAEConfig(**vae_kw), JaxTrainConfig(**train)
    vae_j, disc_j, lpips_j = jae.VAE(cfg=vae_cfg_j), JaxDisc(), JaxLPIPS()
    g_params = _params(2, attn_chunk=64)
    d_params = randomize_params(disc_j.init(jax.random.PRNGKey(1), x0)["params"], 1)
    lpips_params = jax.device_get(lpips_j.init(jax.random.PRNGKey(2), x0, x0)["params"])
    state_j, g_tx, d_tx = jax_create_train_state(cfg_j, g_params, d_params, 32,
                                                 jax.random.PRNGKey(3))
    jstep = jax_make_train_step(cfg_j, vae_cfg_j, vae_j, disc_j, lpips_j, g_tx, d_tx)

    vae_cfg, cfg = VAEConfig(**vae_kw), TrainConfig(**train)
    vae, disc, lpips = ae.VAE(vae_cfg), PatchDiscriminator(), LPIPS()
    vae.load_state_dict(jax_params_to_state_dict(g_params), strict=True)
    disc.load_state_dict(jax_disc_params_to_state_dict(d_params), strict=True)
    lpips.load_state_dict(jax_lpips_params_to_state_dict(lpips_params), strict=True)
    state = create_train_state(cfg, vae, disc, vae_cfg.ch, seed=0)
    step = make_train_step(cfg, vae_cfg, vae, disc, lpips)

    # the JAX step draws its coins from its key; the port's step takes them
    draws, _ = _jax_draws(state_j.rng, 16, 12)
    batch = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    state_j, m_j = jax.jit(jstep, static_argnums=(3,))(state_j, jnp.asarray(batch),
                                                       lpips_params, 0)
    state, m = step(state, torch.from_numpy(batch), 0, draws)
    return {
        "metrics": ({k: float(v) for k, v in m_j.items()}, {k: float(v) for k, v in m.items()}),
        "mu_g": jax_params_to_state_dict(_mu_tree(state_j.g_opt)),
        "mu_d": jax_disc_params_to_state_dict(_mu_tree(state_j.d_opt)),
        "exp_avg_g": {n: state.g_opt.state[p]["exp_avg"].clone()
                      for n, p in vae.named_parameters()},
        "exp_avg_d": {n: state.d_opt.state[p]["exp_avg"].clone()
                      for n, p in disc.named_parameters()},
    }


def test_attention_step_gradients_match_jax(step_runs):
    """Step-1 gradients read from AdamW's first moments against optax's mu
    (tests/test_torch_train_step.py's bounds), the AttnBlocks' qkv and
    proj_out weights included and non-zero."""
    for side in ("g", "d"):
        ref = step_runs[f"mu_{side}"]
        floor = ZERO_FLOOR * max(float(r.abs().max()) for r in ref.values())
        _check_tensors(step_runs[f"exp_avg_{side}"], ref, GRAD_RTOL, floor)
    g = step_runs["exp_avg_g"]
    for side in ("encoder", "decoder"):
        for name in ("qkv.weight", "proj_out.weight", "norm.weight"):
            assert float(g[f"{side}.mid.attn_1.{name}"].abs().max()) > 0


def test_attention_step_metrics_match_jax(step_runs):
    ref, got = step_runs["metrics"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        # the repo's bound for a loss against another implementation
        np.testing.assert_allclose(got[k], v, rtol=8e-3, atol=8e-4, err_msg=k)
