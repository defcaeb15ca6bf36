"""The port's eval path against the JAX package's, on the CPU: PSNR and SSIM,
the Fréchet distance and the VGG features it fits, ``make_eval_step``
(identity and sampled Gaussian latents, fp32 and the bf16 eval, flip
invariance on and off, a uint8 batch) and ``tile_grid``.

The eval step is held at ``TINY`` (ch=32, ch_mult 1,2, 32 px), from JAX
params made non-trivial with ``randomize_params``; the Gaussian eval takes
the JAX eval's ε, the normal draw of ``PRNGKey(0)`` read through the JAX
VAE's own ``regularize``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.fid import frechet_distance as jax_frechet_distance
from vqgan_tpu.losses.fid import make_feature_fn as jax_make_feature_fn
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.losses.metrics import psnr as jax_psnr
from vqgan_tpu.losses.metrics import ssim as jax_ssim
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.train.evaluate import make_eval_step as jax_make_eval_step
from vqgan_tpu.train.evaluate import tile_grid as jax_tile_grid
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.losses.fid import frechet_distance, make_feature_fn
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.losses.metrics import psnr, ssim
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.train.evaluate import make_eval_step, tile_grid
from vqgan_tpu_torch.weights import jax_lpips_params_to_state_dict, jax_params_to_state_dict

from torch_parity import randomize_params

TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            enc_dtype="float32", dec_dtype="float32")
# the metrics: fp32 on both sides, sums in other orders
METRIC_TOL = 1e-6
# the eval step: fp32 recon in [0, 1] through 8 convs and 12 GroupNorms in
# other summation orders; the bf16 eval rounds every conv output on either
# side, so single pixels may differ by a bf16 ulp of an activation
EVAL_ATOL_FP32 = 1e-5
EVAL_MEAN_BF16 = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, shape=(3, 24, 24, 3)):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_and_ssim_match_jax(seed):
    a, b = _images(seed)
    for port_fn, jax_fn in ((psnr, jax_psnr), (ssim, jax_ssim)):
        got = float(port_fn(torch.from_numpy(a), torch.from_numpy(b)))
        ref = float(jax_fn(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, ref, rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=port_fn.__name__)


def test_ssim_of_equal_images_is_one_and_bounded():
    a, b = _images(2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert float(ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)
    assert -1.0 <= float(ssim(ta, 1 - tb)) <= 1.0
    assert float(psnr(ta, ta)) == pytest.approx(120.0)  # the 1e-12 mse floor


@pytest.mark.parametrize("n,c", [(16, 8), (40, 32)])
def test_frechet_distance_matches_jax(n, c):
    rng = np.random.RandomState(n)
    fa = rng.randn(n, c).astype(np.float32)
    fb = (0.8 * rng.randn(n, c) + 0.3).astype(np.float32)
    got, ref = frechet_distance(fa, fb), jax_frechet_distance(fa, fb)
    np.testing.assert_allclose(got, ref, rtol=METRIC_TOL)
    assert frechet_distance(fa, fa) == pytest.approx(0.0, abs=1e-3)


def _shapes(module, *args):
    """A flax module's param shapes, without running its init (an op-by-op
    init compiles once per op); ``randomize_params`` fills them."""
    return jax.eval_shape(module.init, *args)["params"]


@pytest.mark.parametrize("taps", [(-1,), (2, 3, 4)])
def test_feature_fn_matches_jax(taps):
    """The pooled VGG taps of LPIPS's VGG, from the same weights: fp32 convs
    in other orders, relative to the largest feature."""
    x0 = jnp.zeros((1, 32, 32, 3))
    params = randomize_params(_shapes(JaxLPIPS(), jax.random.PRNGKey(4), x0, x0), 4)
    lpips = LPIPS()
    lpips.load_state_dict(jax_lpips_params_to_state_dict(params), strict=True)
    x = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax_make_feature_fn(params["vgg"], taps=taps)(jnp.asarray(x)))
    got = make_feature_fn(lpips.net.state_dict(), "cpu", taps=taps)(torch.from_numpy(x))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4 * np.abs(ref).max())


def test_tile_grid_matches_jax():
    imgs = np.random.RandomState(6).rand(7, 40, 24, 3).astype(np.float32)
    for rows, cols, d in ((2, 4, 32), (1, 3, 16), (3, 3, 48)):
        np.testing.assert_array_equal(tile_grid(imgs, rows, cols, d),
                                      jax_tile_grid(imgs, rows, cols, d))


@pytest.fixture(scope="module")
def models():
    out = {}
    for reg in ("identity_gaussian", "gaussian"):
        vae_cfg_j = JaxVAEConfig(**TINY, reg_type=reg)
        vae_j = JaxVAE(cfg=vae_cfg_j)
        params = randomize_params(_shapes(vae_j, {"params": jax.random.PRNGKey(0),
                                                  "sample": jax.random.PRNGKey(1)},
                                          jnp.zeros((1, 32, 32, 3))), 7)
        vae = VAE(VAEConfig(**TINY, reg_type=reg))
        vae.load_state_dict(jax_params_to_state_dict(params), strict=True)
        out[reg] = (vae_j, params, vae)
    return out


CASES = [  # (reg_type, eval_bf16, flip_invariance, uint8 batch)
    ("identity_gaussian", False, False, False),
    ("identity_gaussian", False, True, True),
    ("gaussian", False, True, False),
    ("identity_gaussian", True, True, False),
    ("gaussian", True, False, True),
]


@pytest.mark.parametrize("reg,bf16,flip,uint8", CASES,
                         ids=["id-fp32", "id-fp32-flip-u8", "gauss-fp32-flip", "id-bf16-flip",
                              "gauss-bf16-u8"])
def test_eval_step_matches_jax(models, reg, bf16, flip, uint8):
    vae_j, params, vae = models[reg]
    kw = dict(do_clamp=True, clamp_th=1.0, flip_invariance=flip, eval_bf16=bf16)
    cfg_j, cfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    rng = np.random.RandomState(8)
    if uint8:  # 64 px: the area resize to the encoder's 32 as well
        batch = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    else:
        batch = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    r_j, t_j = jax_make_eval_step(cfg_j, vae_j.cfg, vae_j)(params, None, jnp.asarray(batch))
    eps = None
    if reg == "gaussian":
        # the JAX eval's ε: its DiagonalGaussian at mean 0, logvar 0, from
        # PRNGKey(0), in the eval encoder's dtype
        eval_cfg = dataclasses.replace(vae_j.cfg, enc_dtype="bfloat16", dec_dtype="bfloat16") \
            if bf16 else vae_j.cfg
        dt = jnp.bfloat16 if bf16 else jnp.float32
        zeros = jnp.zeros((2, 16, 16, 2 * TINY["z_channels"]), dt)
        e = jax.jit(lambda p: JaxVAE(cfg=eval_cfg).apply(
            {"params": p}, zeros, method=JaxVAE.regularize,
            rngs={"sample": jax.random.PRNGKey(0)}))(params)
        eps = torch.from_numpy(np.asarray(e, np.float32)).to(torch.bfloat16 if bf16
                                                             else torch.float32)
    step = make_eval_step(cfg, vae.cfg, vae)
    r, t = step(dict(vae.named_parameters()), torch.from_numpy(batch), eps)
    assert r.dtype == t.dtype == torch.float32
    assert r.shape == r_j.shape and t.shape == t_j.shape
    # the target: (x / 127.5 - 1) * 0.5 + 0.5, which XLA may fuse (one ulp)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=0, atol=1e-7)
    err = np.abs(r.numpy() - np.asarray(r_j))
    if bf16:
        assert err.mean() <= EVAL_MEAN_BF16, err.mean()
    else:
        assert err.max() <= EVAL_ATOL_FP32, err.max()


def test_eval_step_default_eps_is_fixed_and_params_are_copied(models):
    """Without a given ε the Gaussian eval draws it from a generator seeded
    0: two calls agree. The params come from the mapping it is given."""
    _, _, vae = models["gaussian"]
    step = make_eval_step(TrainConfig(eval_bf16=False), vae.cfg, vae)
    batch = torch.from_numpy(np.random.RandomState(9).uniform(-1, 1, (2, 32, 32, 3))
                             .astype(np.float32))
    params = dict(vae.named_parameters())
    r1, _ = step(params, batch)
    r2, _ = step(params, batch)
    assert torch.equal(r1, r2)
    shifted = {k: v + 0.01 if k == "decoder.conv_out.bias" else v for k, v in params.items()}
    r3, _ = step(shifted, batch)
    assert not torch.equal(r1, r3)
