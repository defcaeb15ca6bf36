"""The port's 3D (TVAE) train steps against the JAX package's, on the CPU.

The config is tests/test_trainer3d.py's tiny TVAE (ch 32, ch_mult 1,2, 1 res
block, z 8, 16 px, 4 frames) in fp32 with the direct Conv3d on both sides,
batch 2. JAX params come from ``jax.eval_shape`` filled by numpy
(``randomize_params``: an op-by-op flax init of a TVAE is slow), the
discriminator's zero-init final heads included, so the GAN branch reaches G.
Both sides take the same clips and the JAX step's own draws, derived from its
keys as the JAX code does: ε, the frame phase u and the revival rows, handed
to the port as ``Step3DDraws``. Tolerances are the 2D step's
(tests/test_torch_train_step.py): step-1 gradients from AdamW's first moments
against optax's at ``GRAD_RTOL``, a 3-step metric curve at ``CURVE_RTOL``;
D's lr stays at 1e-8.

tests/test_torch_step3d_recon.py runs the recon-only step, and
tests/test_torch_tubelet.py the GAN step with VQ and the tubelet
discriminator, through the harness here (one file per JAX step compile keeps
each file's time short).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.discriminator import TubeletDiscriminator as JaxTubelet
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.train.state import create_train_state as jax_create_train_state
from vqgan_tpu.train.state import make_discriminator_optimizer as jax_d_optimizer
from vqgan_tpu.train.state import make_generator_optimizer as jax_g_optimizer
from vqgan_tpu.train.step3d import _frame_subset as jax_frame_subset
from vqgan_tpu.train.step3d import make_train_step_3d_gan as jax_make_train_step_3d_gan
from vqgan_tpu.train.trainer3d import make_train_step_3d as jax_make_train_step_3d
from vqgan_tpu.train.trainer3d import synthetic_video_batches as jax_synthetic_video_batches
from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, TubeletDiscriminator
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.models.tae import TVAE, reparameterize
from vqgan_tpu_torch.train.state import create_train_state
from vqgan_tpu_torch.train.step3d import (
    Step3DDraws,
    frame_subset,
    make_train_step_3d,
    make_train_step_3d_gan,
)
from vqgan_tpu_torch.train.trainer3d import synthetic_video_batches
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
    jax_vq_ema_to_torch,
)

from test_torch_train_step import CURVE_ATOL, CURVE_RTOL, GRAD_RTOL, ZERO_FLOOR, _mu_tree
from torch_parity import randomize_params

TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            compute_dtype="float32", conv3d_impl="direct")
BATCH, FRAMES, RES = 2, 4, 16
LATENT = (BATCH, 2, 8, 8)  # (B, t, h, w) after the one downsample
K = 32
VQ = dict(reg_type="vq", vq_codebook_size=K, vq_ema_decay=0.9, vq_revive_threshold=0.5)
TRAIN = dict(
    batch_size=BATCH, image_size=RES, max_steps=10, warmup_steps=2,
    learning_rate_vae=0.032, learning_rate_disc=1e-8, do_ganloss=True, disc_type="hinge",
    use_lecam=True, video_loss_frames=3, ema_decay=0.5,
)
STEPS = 3
CB = "reg.codebook"


def _vq_ema():
    """EMA counts in [0.3, 1.3) (sums = counts·codebook): codes unused in
    step 1 fall below the revival threshold, 0.9·c < 0.5."""
    counts = np.random.RandomState(6).uniform(0.3, 1.3, K).astype(np.float32)
    return counts


def _clips(rng):
    return rng.uniform(-1, 1, (BATCH, FRAMES, RES, RES, 3)).astype(np.float32)


def _models(tvae_kw):
    """The flax TVAE with numpy-filled params, and the port's TVAE loaded
    from them; the VQ EMA statistics of both sides when EMA is on."""
    tvae_cfg_j = JaxTVAEConfig(**tvae_kw)
    model_j = JaxTVAE(cfg=tvae_cfg_j)
    x0 = jnp.zeros((1, FRAMES, RES, RES, 3))
    shapes = jax.eval_shape(model_j.init, {"params": jax.random.PRNGKey(0),
                                           "sample": jax.random.PRNGKey(0)}, x0)
    g_params = randomize_params(shapes["params"], 0)
    model = TVAE(TVAEConfig(**tvae_kw))
    model.load_state_dict(jax_params_to_state_dict(g_params), strict=True)
    vq_ema_j = vq_ema = None
    if tvae_kw.get("reg_type") == "vq":
        counts = _vq_ema()
        vq_ema_j = {"reg": {"counts": jnp.asarray(counts),
                            "sums": jnp.asarray(counts[:, None] * g_params["reg"]["codebook"])}}
        vq_ema = jax_vq_ema_to_torch(vq_ema_j)
    return tvae_cfg_j, model_j, g_params, vq_ema_j, model, vq_ema


def _jax_draws(keys, n_tokens, latent_mean, k_frames=None, vq=False):
    """The draws of the JAX steps from their keys: (k_sample, k_revive) and,
    for the GAN step, k_frames."""
    k_sample, k_revive = keys
    draws = Step3DDraws()
    if not vq:
        draws.eps = torch.from_numpy(np.array(
            jax.random.normal(k_sample, latent_mean), np.float32))
    if k_frames is not None:
        draws.frame_u = torch.tensor(float(jax.random.uniform(k_frames, ())))
    if vq:
        draws.revive_idx = torch.from_numpy(np.asarray(
            jax.random.randint(k_revive, (K,), 0, n_tokens), np.int64))
    return draws


def _snapshot(out, side, metrics, params, vq_ema, g_ema):
    out[side].append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "params": params, "vq_ema": vq_ema, "g_ema": g_ema})


def run_recon_only(tvae_kw, steps=STEPS):
    """make_train_step_3d on both sides: per step the metrics, params and EMA
    statistics; step 1's first moments."""
    tvae_cfg_j, model_j, g_params, vq_ema_j, model, vq_ema = _models(tvae_kw)
    cfg_j, cfg = JaxTrainConfig(**TRAIN), TrainConfig(**TRAIN)
    tx = optax.adamw(cfg_j.learning_rate_vae / tvae_cfg_j.ch, b1=cfg_j.beta1, b2=cfg_j.beta2,
                     weight_decay=cfg_j.weight_decay)
    jstep = jax.jit(jax_make_train_step_3d(cfg_j, tvae_cfg_j, model_j, tx))
    # jitted: one compile, not one per parameter shape
    params_j, opt_j, jrng = g_params, jax.jit(tx.init)(g_params), jax.random.PRNGKey(4)
    state = create_train_state(cfg, model, None, tvae_cfg_j.ch, vq_ema=vq_ema, recon_only=True)
    step = make_train_step_3d(cfg, TVAEConfig(**tvae_kw), model)
    vq = vq_ema is not None
    rng = np.random.RandomState(5)
    out = {"jax": [], "port": []}
    for i in range(steps):
        clips = _clips(rng)
        _, sub, k_revive = jax.random.split(jrng, 3)
        draws = _jax_draws((sub, k_revive), int(np.prod(LATENT)), (*LATENT, 8), vq=vq)
        params_j, opt_j, jrng, vq_ema_j, m_j = jstep(params_j, opt_j, jnp.asarray(clips), jrng,
                                                     vq_ema_j)
        state, m = step(state, torch.from_numpy(clips), draws)
        _snapshot(out, "jax", m_j, jax_params_to_state_dict(jax.device_get(params_j)),
                  None if vq_ema_j is None else jax_vq_ema_to_torch(jax.device_get(vq_ema_j)),
                  None)
        _snapshot(out, "port", m, {k: v.detach().clone() for k, v in model.named_parameters()},
                  None if state.vq_ema is None
                  else {k: v.clone() for k, v in state.vq_ema.items()}, None)
        if i == 0:
            out["mu_g"] = jax_params_to_state_dict(_mu_tree(opt_j))
            out["exp_avg_g"] = {n: state.g_opt.state[p]["exp_avg"].clone()
                                for n, p in model.named_parameters() if p in state.g_opt.state}
    return out


def run_gan(tvae_kw, disc_3d, steps=STEPS, **train_kw):
    """make_train_step_3d_gan on both sides with ``disc_3d`` and the
    TrainConfig fields ``train_kw`` over ``TRAIN``: per step the metrics,
    params, EMA statistics and Polyak EMA; step 1's first moments of G and
    D."""
    tvae_cfg_j, model_j, g_params, vq_ema_j, model, vq_ema = _models(tvae_kw)
    train = {**TRAIN, "disc_3d": disc_3d, **train_kw}
    cfg_j, cfg = JaxTrainConfig(**train), TrainConfig(**train)
    k = cfg.video_loss_frames
    if disc_3d == "tubelet":
        disc_j, x_d, disc = JaxTubelet(), jnp.zeros((1, k, RES, RES, 3)), TubeletDiscriminator(k)
    else:
        disc_j, x_d, disc = JaxDisc(), jnp.zeros((1, RES, RES, 3)), PatchDiscriminator()
    d_params = randomize_params(jax.eval_shape(disc_j.init, jax.random.PRNGKey(1), x_d)["params"],
                                1)
    disc.load_state_dict(jax_disc_params_to_state_dict(d_params), strict=True)
    lpips_j = JaxLPIPS()
    x0 = jnp.zeros((1, RES, RES, 3))
    lpips_params = randomize_params(
        jax.eval_shape(lpips_j.init, jax.random.PRNGKey(2), x0, x0)["params"], 2)
    lpips = LPIPS()
    lpips.load_state_dict(jax_lpips_params_to_state_dict(lpips_params), strict=True)
    # the JAX state, jitted (one compile, not one per parameter shape), and
    # the optimizers create_train_state builds
    state_j = jax.jit(lambda g, d, e: jax_create_train_state(
        cfg_j, g, d, tvae_cfg_j.ch, jax.random.PRNGKey(3), vq_ema=e)[0])(
        g_params, d_params, vq_ema_j)
    g_tx, d_tx = jax_g_optimizer(cfg_j, tvae_cfg_j.ch, g_params), jax_d_optimizer(cfg_j)
    jstep = jax.jit(jax_make_train_step_3d_gan(cfg_j, tvae_cfg_j, model_j, disc_j, lpips_j,
                                               g_tx, d_tx))
    state = create_train_state(cfg, model, disc, tvae_cfg_j.ch, vq_ema=vq_ema)
    step = make_train_step_3d_gan(cfg, TVAEConfig(**tvae_kw), model, disc, lpips)
    vq = vq_ema is not None
    rng = np.random.RandomState(5)
    out = {"jax": [], "port": []}
    for i in range(steps):
        clips = _clips(rng)
        k_sample, k_frames, k_revive = jax.random.split(jax.random.split(state_j.rng)[0], 3)
        draws = _jax_draws((k_sample, k_revive), int(np.prod(LATENT)), (*LATENT, 8),
                           k_frames=k_frames, vq=vq)
        state_j, m_j = jstep(state_j, jnp.asarray(clips), lpips_params)
        state, m = step(state, torch.from_numpy(clips), draws)
        _snapshot(out, "jax", m_j, jax_params_to_state_dict(jax.device_get(state_j.g_params)),
                  None if state_j.vq_ema is None
                  else jax_vq_ema_to_torch(jax.device_get(state_j.vq_ema)),
                  jax_params_to_state_dict(jax.device_get(state_j.g_ema)))
        _snapshot(out, "port", m, {n: v.detach().clone() for n, v in model.named_parameters()},
                  None if state.vq_ema is None
                  else {n: v.clone() for n, v in state.vq_ema.items()},
                  {n: v.clone() for n, v in state.g_ema.items()})
        if i == 0:
            out["mu_g"] = jax_params_to_state_dict(_mu_tree(state_j.g_opt))
            out["mu_d"] = jax_disc_params_to_state_dict(_mu_tree(state_j.d_opt))
            out["exp_avg_g"] = {n: state.g_opt.state[p]["exp_avg"].clone()
                                for n, p in model.named_parameters() if p in state.g_opt.state}
            out["exp_avg_d"] = {n: state.d_opt.state[p]["exp_avg"].clone()
                                for n, p in disc.named_parameters()}
    return out


def check_gradients(run, side="g", vq_ema=False):
    """Step-1 first moments per tensor within GRAD_RTOL of its largest entry,
    floored at ZERO_FLOOR of the largest entry of all (gradients that are 0
    in exact arithmetic: conv biases feeding one-channel GroupNorm groups)."""
    ref, got = dict(run[f"mu_{side}"]), run[f"exp_avg_{side}"]
    if side == "g" and vq_ema:  # no gradient reaches the EMA codebook
        assert CB not in got and float(ref.pop(CB).abs().max()) == 0.0
    assert set(got) == set(ref)
    floor = ZERO_FLOOR * max(float(r.abs().max()) for r in ref.values())
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        assert err <= GRAD_RTOL * float(r.abs().max()) + floor, (name, err)


def check_curve(run, i, want_keys):
    ref, got = run["jax"][i]["metrics"], run["port"][i]["metrics"]
    assert set(got) == set(ref) == set(want_keys)
    for name, v in ref.items():
        np.testing.assert_allclose(got[name], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                   err_msg=f"step {i} {name}")


def check_vq_statistics(run, i):
    """EMA counts within one token (0.1 per code moved); the sums and the
    folded codebook within CURVE_RTOL of their largest entry (the encoder's z
    of two implementations); some code revived in step 1."""
    ref, got = run["jax"][i]["vq_ema"], run["port"][i]["vq_ema"]
    assert float((got["counts"] - ref["counts"]).abs().sum()) <= 0.2 + 1e-4
    assert float((got["sums"] - ref["sums"]).abs().max()) <= (
        CURVE_RTOL * float(ref["sums"].abs().max()))
    cb_ref, cb = run["jax"][i]["params"][CB], run["port"][i]["params"][CB]
    assert float((cb - cb_ref).abs().max()) <= CURVE_RTOL * float(cb_ref.abs().max())
    if i == 0:
        assert 0 < int((got["counts"] < 0.5).sum()) < K


RECON_KEYS = ("recon_l2", "kl", "loss")
GAN_KEYS = ("perceptual_loss", "recon_l2", "kl", "gan/generator_gan_loss", "overall_vae_loss",
            "loss", "gan/discriminator_loss", "gan/discriminator_accuracy",
            "gan/avg_real_logits", "gan/avg_fake_logits", "gan/lecam_loss",
            "gan/lecam_anchor_real_logits", "gan/lecam_anchor_fake_logits")


@pytest.fixture(scope="module")
def gan_frame():
    return run_gan(TINY, "frame")


def test_reparameterize_matches_jax():
    """step3d.py:90-97 in jnp with the same ε: sample, KL and the KL's
    gradient (0 below the logvar clip at −3)."""
    rng = np.random.RandomState(0)
    z = (2.0 * rng.randn(2, 2, 4, 4, 16)).astype(np.float32)
    eps = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 2, 4, 4, 8)), np.float32)

    def jax_ref(z):
        mean, logvar = jnp.split(z.astype(jnp.float32), 2, axis=-1)
        logvar = jnp.clip(logvar, min=-3.0)
        z_s = (mean + jnp.exp(0.5 * logvar) * eps).astype(z.dtype)
        return z_s, 0.5 * jnp.mean(mean**2 + jnp.exp(logvar) - 1.0 - logvar)

    z_s_ref, kl_ref = jax_ref(jnp.asarray(z))
    dkl_ref = jax.grad(lambda z: jax_ref(z)[1])(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    z_s, kl = reparameterize(zt, torch.from_numpy(eps))
    kl.backward()
    np.testing.assert_allclose(z_s.detach().numpy(), np.asarray(z_s_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(kl.detach()), float(kl_ref), rtol=1e-6)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(dkl_ref), rtol=1e-5, atol=1e-9)
    assert (z[..., 8:] < -3).any() and (zt.grad.numpy()[..., 8:][z[..., 8:] < -3] == 0).all()
    z_bf16 = reparameterize(zt.detach().bfloat16(), torch.from_numpy(eps))[0]
    assert z_bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("k", [3, 8, 9, 0])
def test_frame_subset_matches_jax(k):
    """T = 8: k = 3 strides by 8/3 with the phase u (every frame reachable);
    k >= T and k <= 0 keep every frame."""
    clip = np.arange(2 * 8, dtype=np.float32).reshape(2, 8, 1)
    other = -clip
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = jax_frame_subset(key, (jnp.asarray(clip), jnp.asarray(other)), k)
        u = torch.tensor(float(jax.random.uniform(key, ())))
        got = frame_subset((torch.from_numpy(clip), torch.from_numpy(other)), k, u)
        assert len(got) == 2
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_synthetic_video_batches_match_jax():
    ref, got = jax_synthetic_video_batches(2, 3, 8, seed=1), synthetic_video_batches(2, 3, 8, 1)
    for _ in range(2):
        np.testing.assert_array_equal(next(got), next(ref))


@pytest.mark.parametrize("side", ["g", "d"])
def test_gan_frame_step1_gradients_match_jax(gan_frame, side):
    check_gradients(gan_frame, side)


@pytest.mark.parametrize("i", range(STEPS))
def test_gan_frame_curve_matches_jax(gan_frame, i):
    check_curve(gan_frame, i, GAN_KEYS)


def test_gan_frame_polyak_ema_matches_jax(gan_frame):
    ref, got = gan_frame["jax"][-1]["g_ema"], gan_frame["port"][-1]["g_ema"]
    scale = max(float(r.abs().max()) for r in ref.values())
    assert max(float((got[n] - r).abs().max()) for n, r in ref.items()) <= CURVE_RTOL * scale


def test_unported_options_raise():
    tvae_cfg = TVAEConfig(**TINY)
    with pytest.raises(ValueError, match="disc_3d"):
        make_train_step_3d_gan(dataclasses.replace(TrainConfig(**TRAIN), disc_3d="bogus"),
                               tvae_cfg, TVAE(tvae_cfg), PatchDiscriminator(), LPIPS())


def test_steps_draw_from_the_state_generator():
    """Without given draws, ε, the frame phase and the revival rows come from
    the state's generator: two runs from one seed agree exactly."""
    from vqgan_tpu_torch.losses.discriminator import init_discriminator_
    from vqgan_tpu_torch.losses.lpips import init_lpips_
    from vqgan_tpu_torch.models.tae import init_tvae

    clips = torch.from_numpy(_clips(np.random.RandomState(1)))
    finals = []
    for _ in range(2):
        tvae_cfg = TVAEConfig(**{**TINY, **VQ})
        gen = torch.Generator().manual_seed(0)
        model, disc, lpips = init_tvae(tvae_cfg, gen), PatchDiscriminator(), LPIPS()
        init_discriminator_(disc, gen)
        init_lpips_(lpips, gen)
        cfg = TrainConfig(**TRAIN)
        state = create_train_state(cfg, model, disc, tvae_cfg.ch, seed=3)
        state, m = make_train_step_3d_gan(cfg, tvae_cfg, model, disc, lpips)(state, clips)
        assert all(np.isfinite(float(v)) for v in m.values()) and state.step == 1
        finals.append(model.reg.codebook.detach().clone())
    assert torch.equal(finals[0], finals[1])
