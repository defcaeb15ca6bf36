"""The port's microbatched GAN step (``make_train_step`` with ``grad_accum``
> 1) against the JAX package's ``step_accum``, on the CPU.

The config has the feature set of ``tools/launch_hdr.sh`` at a tiny width:
the wavelet encoder and the HR decoder (ch 32, ch_mult 1,2, 16 px in, 32 px
out), hinge + LeCam, the clamp, flip and crop invariance; with the sampled
Gaussian latent, the heatmap-masked L1 (``do_pool_recon=False``,
``recon_weight=1.0``) and ``image_size=24``, so the encoder's resize goes
down (24 → 16) and the HR target's up (24 → 32), both by the antialiased
linear resize. ``grad_accum=2`` at batch 4; both steps in crop bucket 1 (one
JAX compile). The port takes the JAX step's draws: one coin set and crop
offsets a step from ``split(rng, 8)``, and for microbatch i the ε of
``fold_in(keys[1], i)``, the same in both passes.

Checked as tests/test_torch_train_step.py checks the plain step: step-1
first moments of G and D per tensor within ``GRAD_RTOL`` (floor
``ZERO_FLOOR``), two steps' metrics within ``CURVE_RTOL``/``CURVE_ATOL``, and
the Polyak EMA. Then, port only: with ``remat`` (the model's regions, LPIPS
and D) the accumulated step is bitwise the plain one; the draws' ε rows go to the
microbatches in order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.train.state import create_train_state as jax_create_train_state
from vqgan_tpu.train.state import make_discriminator_optimizer as jax_d_optimizer
from vqgan_tpu.train.state import make_generator_optimizer as jax_g_optimizer
from vqgan_tpu.train.step import make_train_step as jax_make_train_step
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.train.state import create_train_state
from vqgan_tpu_torch.train.step import StepDraws, make_train_step
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
)

from test_torch_train_step import (
    CURVE_ATOL,
    CURVE_RTOL,
    GRAD_RTOL,
    ZERO_FLOOR,
    _check_tensors,
    _mu_tree,
    jax_eps_sampler,
)
from torch_parity import randomize_params

HDR_TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                use_wavelet=True, decoder_also_perform_hr=True, reg_type="gaussian",
                enc_dtype="float32", dec_dtype="float32")
ACCUM, BATCH, IMAGE = 2, 4, 24
TRAIN = dict(
    batch_size=BATCH, image_size=IMAGE, max_steps=10, warmup_steps=2, grad_accum=ACCUM,
    # D's lr as tests/test_torch_train_step.py's, for the reason given there
    learning_rate_vae=0.032, learning_rate_disc=1e-8,
    do_ganloss=True, disc_type="hinge", use_lecam=True, do_clamp=True, clamp_th=8.0,
    flip_invariance=True, crop_invariance=True, downscale_factor=2,
    do_pool_recon=False, recon_weight=1.0, ema_decay=0.5,
)
Z_SIDE, CROP_BUCKET, STEPS = 8, 1, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def accum_draws(rng, sample, crop_side):
    """The JAX ``step_accum``'s draws for state.rng = ``rng`` (its keys as
    ``vqgan_tpu/train/step.py:447-464`` derives them), and the next rng: the
    step's coins and crop offsets, and ε stacked over the microbatches, row
    block i from ``fold_in(keys[1], i)``."""
    rng, new_rng = jax.random.split(rng)
    keys = jax.random.split(rng, 8)
    coin = lambda k: bool(jax.random.bernoulli(k))  # noqa: E731
    koff_h, koff_w = jax.random.split(keys[4])
    hi = Z_SIDE - crop_side + 1
    eps = np.concatenate([np.array(sample(jax.random.fold_in(keys[1], i)), np.float32)
                          for i in range(ACCUM)])
    draws = StepDraws(
        flip_in=coin(keys[0]), flip_w=coin(keys[2]), flip_h=coin(keys[3]),
        crop_h=int(jax.random.randint(koff_h, (), 0, hi)),
        crop_w=int(jax.random.randint(koff_w, (), 0, hi)),
        aug_lpips_w=coin(keys[5]), aug_lpips_h=coin(keys[6]),
        eps=torch.from_numpy(eps))
    return draws, new_rng


def _batches():
    rng = np.random.RandomState(7)
    return [rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
            for _ in range(STEPS)]


def _port(params, d_params, lpips_params, **vae_kw):
    vae_cfg = VAEConfig(**HDR_TINY, **vae_kw)
    cfg = TrainConfig(**TRAIN)
    vae = VAE(vae_cfg)
    vae.load_state_dict(jax_params_to_state_dict(params), strict=True)
    disc = PatchDiscriminator()
    disc.load_state_dict(jax_disc_params_to_state_dict(d_params), strict=True)
    lpips = LPIPS()
    lpips.load_state_dict(jax_lpips_params_to_state_dict(lpips_params), strict=True)
    state = create_train_state(cfg, vae, disc, vae_cfg.ch, seed=0)
    return vae, disc, state, make_train_step(cfg, vae_cfg, vae, disc, lpips)


@pytest.fixture(scope="module")
def runs():
    vae_cfg_j = JaxVAEConfig(**HDR_TINY)
    cfg_j = JaxTrainConfig(**TRAIN)
    vae_j, disc_j, lpips_j = JaxVAE(cfg=vae_cfg_j), JaxDisc(), JaxLPIPS()
    x0, x_hr = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1, 32, 32, 3))
    key = jax.random.PRNGKey(0)
    g_params = randomize_params(jax.eval_shape(vae_j.init, {"params": key, "sample": key},
                                               x0)["params"], 0)
    d_params = randomize_params(jax.eval_shape(disc_j.init, jax.random.PRNGKey(1),
                                               x_hr)["params"], 1)
    lpips_params = randomize_params(jax.eval_shape(lpips_j.init, jax.random.PRNGKey(2),
                                                   x_hr, x_hr)["params"], 2)
    # the JAX state, jitted (one compile, not one per parameter shape), and
    # the optimizers create_train_state builds
    state_j = jax.jit(lambda g, d: jax_create_train_state(
        cfg_j, g, d, HDR_TINY["ch"], jax.random.PRNGKey(3))[0])(g_params, d_params)
    g_tx, d_tx = jax_g_optimizer(cfg_j, HDR_TINY["ch"], g_params), jax_d_optimizer(cfg_j)
    jstep = jax.jit(jax_make_train_step(cfg_j, vae_cfg_j, vae_j, disc_j, lpips_j, g_tx, d_tx),
                    static_argnums=(3,))
    sample = jax_eps_sampler(vae_j, g_params, (BATCH // ACCUM, Z_SIDE, Z_SIDE, 8))
    vae, disc, state, step = _port(g_params, d_params, lpips_params)

    crop_side = int(round(TrainConfig().crop_fractions[CROP_BUCKET - 1] * Z_SIDE))
    out = {"jax": [], "port": [], "draws": [], "batches": _batches(),
           "weights": (g_params, d_params, lpips_params)}
    jrng = state_j.rng
    for i, batch in enumerate(out["batches"]):
        draws, jrng = accum_draws(jrng, sample, crop_side)
        out["draws"].append(draws)
        state_j, m_j = jstep(state_j, jnp.asarray(batch), lpips_params, CROP_BUCKET)
        state, m = step(state, torch.from_numpy(batch), CROP_BUCKET,
                        dataclasses.replace(draws))
        out["jax"].append({k: float(v) for k, v in m_j.items()})
        out["port"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["mu_g"] = jax_params_to_state_dict(_mu_tree(state_j.g_opt))
            out["mu_d"] = jax_disc_params_to_state_dict(_mu_tree(state_j.d_opt))
            out["exp_avg_g"] = {n: state.g_opt.state[p]["exp_avg"].clone()
                                for n, p in vae.named_parameters()}
            out["exp_avg_d"] = {n: state.d_opt.state[p]["exp_avg"].clone()
                                for n, p in disc.named_parameters()}
    out["ema_jax"] = jax_params_to_state_dict(jax.device_get(state_j.g_ema))
    out["ema_port"] = {k: v.clone() for k, v in state.g_ema.items()}
    out["port_final"] = {k: v.detach().clone() for k, v in vae.named_parameters()}
    return out


@pytest.mark.parametrize("side", ["g", "d"])
def test_accum_step1_gradients_match_jax(runs, side):
    ref = runs[f"mu_{side}"]
    floor = ZERO_FLOOR * max(float(r.abs().max()) for r in ref.values())
    _check_tensors(runs[f"exp_avg_{side}"], ref, GRAD_RTOL, floor)


@pytest.mark.parametrize("i", range(STEPS))
def test_accum_curve_matches_jax(runs, i):
    ref, got = runs["jax"][i], runs["port"][i]
    assert set(got) == set(ref)
    assert {"recon_loss", "gan/lecam_anchor_real_logits", "z_quantiles/kurtosis"} <= set(got)
    assert got["recon_loss"] > 0  # the heatmap-masked L1 is on
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                   err_msg=f"step {i} {k}")


def test_accum_polyak_ema_matches_jax(runs):
    ref, got = runs["ema_jax"], runs["ema_port"]
    scale = max(float(r.abs().max()) for r in ref.values())
    assert max(float((got[n] - r).abs().max()) for n, r in ref.items()) <= CURVE_RTOL * scale


def test_accum_step_with_remat_is_bitwise(runs):
    """The same two steps from the same weights and draws with ``remat``
    (the model's regions, LPIPS and D; tests/test_torch_remat.py holds both
    policies on the model): metrics and weights bitwise the fixture's port
    run."""
    vae, _, state, step = _port(*runs["weights"], remat=True)
    for batch, draws, ref in zip(runs["batches"], runs["draws"], runs["port"]):
        state, m = step(state, torch.from_numpy(batch), CROP_BUCKET, dataclasses.replace(draws))
        assert {k: float(v) for k, v in m.items()} == ref
    for name, p in vae.named_parameters():
        assert torch.equal(p.detach(), runs["port_final"][name]), name


def test_accum_takes_epsilon_rows_in_microbatch_order(runs):
    """Microbatch i decodes with rows [i·B/k, (i+1)·B/k) of the draws' ε:
    swapping the two microbatches of the batch and of ε gives the same
    step (every loss is a per-microbatch mean, and the metrics' mean over
    two microbatches does not depend on their order up to rounding)."""
    batch, draws = runs["batches"][0], runs["draws"][0]
    half = BATCH // ACCUM
    swapped = np.concatenate([batch[half:], batch[:half]])
    eps = torch.cat([draws.eps[half:], draws.eps[:half]])
    _, _, state, step = _port(*runs["weights"])
    _, m = step(state, torch.from_numpy(swapped), CROP_BUCKET,
                dataclasses.replace(draws, eps=eps))
    for k, v in runs["port"][0].items():
        if k.startswith("gan/lecam_anchor") or k.startswith("gan/"):
            continue  # the anchors advance a microbatch at a time: order matters
        np.testing.assert_allclose(float(m[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)
