"""The port's GAN train step against the JAX package's, on the CPU.

Both sides start from the same params (the flax init made non-trivial with
``randomize_params``, the discriminator's zero-init final heads included),
take the same batches and the same random draws: the JAX step's own coins
and crop offsets, derived from its keys as ``vqgan_tpu/train/step.py`` does
(``split(state.rng)``, then ``split(rng, 8)``), are handed to the port's step
as ``draws``. The config is ``TINY_VAE`` of tests/test_train_step.py with
hinge + LeCam + clamp + flip invariance, fp32, batch 4; three plain steps,
then one step in crop bucket 1. For the sampled Gaussian latent the JAX
step's ε is a draw too: the normal draw of its "sample" key, read through
the JAX VAE's own ``regularize`` (``jax_eps_sampler``);
tests/test_torch_trainer_parity.py holds the Gaussian step against the JAX
step with it, within this file's bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.discriminator import PatchDiscriminator as JaxDisc
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.train.state import create_train_state as jax_create_train_state
from vqgan_tpu.train.state import hf_cosine_schedule as jax_hf_cosine_schedule
from vqgan_tpu.train.step import make_train_step as jax_make_train_step
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
from vqgan_tpu_torch.models.ae import VAE, init_vae
from vqgan_tpu_torch.ops import groupnorm_cuda
from vqgan_tpu_torch.train.state import create_train_state, hf_cosine_schedule
from vqgan_tpu_torch.train.step import StepDraws, make_train_step, z_statistics
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
)

from torch_parity import randomize_params

TINY_VAE = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
                enc_dtype="float32", dec_dtype="float32")
TRAIN = dict(
    batch_size=4, image_size=32, max_steps=10, warmup_steps=2,
    # G's lr is tests/test_full_step_parity.py's: params move visibly in
    # three steps. AdamW's first step moves every D param by ±lr·sign(grad);
    # where a gradient lies within rounding noise of 0 (136 of D's 15M
    # entries here) the two sides step opposite ways, and the GAN branch
    # through the updated D turns that into a 1.4% difference of G's step-1
    # gradient at lr 3e-5. At 1e-8 D still updates, below what the comparison
    # resolves; test_generator_sees_the_updated_discriminator checks the order
    # at a visible lr.
    learning_rate_vae=0.032, learning_rate_disc=1e-8,
    do_ganloss=True, disc_type="hinge", use_lecam=True, do_clamp=True,
    flip_invariance=True, downscale_factor=2, ema_decay=0.5,
)
BATCH = 4
CROP_BUCKET = 1
# the repo's bound for a multi-step loss curve against another
# implementation (tests/test_full_step_parity.py:199)
CURVE_RTOL, CURVE_ATOL = 8e-3, 8e-4
# step-1 gradients (AdamW's first moments, (1 - β1)·grad on both sides),
# per tensor, relative to its largest entry. Beside fp32 summation orders,
# the VGG towers of LPIPS and D have ReLUs (and the hinge its kink): where a
# pre-activation lies within rounding noise of 0 the two sides disagree on
# whether that position passes gradient. Measured 2.2e-3 (G) and 4.8e-3 (D,
# one such position in slice2); the bound leaves 4x and 2x.
GRAD_RTOL = 1e-2
# at ch=32 with 32 groups every GroupNorm group is one channel, so a conv
# bias that only feeds such GroupNorms has a zero gradient in exact
# arithmetic (6 tensors; both sides give rounding noise <= 6e-8): floor at
# 1e-6 of the largest gradient entry
ZERO_FLOOR = 1e-6


def _jax_draws(rng, z_side, crop_side, sample=None):
    """The JAX step's draws for state.rng = ``rng``, and the next rng.
    ``sample``: key → the Gaussian's ε drawn from the "sample" key, for
    ``reg_type="gaussian"``."""
    rng, new_rng = jax.random.split(rng)
    keys = jax.random.split(rng, 8)
    coin = lambda k: bool(jax.random.bernoulli(k))  # noqa: E731
    koff_h, koff_w = jax.random.split(keys[4])
    hi = z_side - crop_side + 1
    draws = StepDraws(
        flip_in=coin(keys[0]), flip_w=coin(keys[2]), flip_h=coin(keys[3]),
        crop_h=int(jax.random.randint(koff_h, (), 0, hi)),
        crop_w=int(jax.random.randint(koff_w, (), 0, hi)),
        aug_lpips_w=coin(keys[5]), aug_lpips_h=coin(keys[6]),
    )
    if sample is not None:
        draws.eps = torch.from_numpy(np.array(sample(keys[1]), np.float32))
    return draws, new_rng


def jax_eps_sampler(vae_j, g_params, shape):
    """key → the ε that the JAX VAE's ``DiagonalGaussian`` draws from the
    "sample" key ``key`` for a latent of ``shape`` (B, h, w, z_channels):
    its sample at mean 0 and logvar 0, which is ε itself."""
    zeros = jnp.zeros(shape[:-1] + (2 * shape[-1],), jnp.float32)
    return jax.jit(lambda key: vae_j.apply({"params": g_params}, zeros,
                                           method=vae_j.regularize, rngs={"sample": key}))


def _mu_tree(opt_state):
    """The first moments of every parameter, from an optax state: the two
    masked groups of the generator's multi_transform merged into one tree."""
    is_masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    found = []

    def visit(node):
        if isinstance(node, optax.ScaleByAdamState):
            found.append(node.mu)
        elif isinstance(node, (tuple, list)):
            for n in node:
                visit(n)
        elif isinstance(node, dict):
            for n in node.values():
                visit(n)
        elif hasattr(node, "_fields"):
            for n in node:
                visit(n)

    visit(opt_state)
    merged = found[0]
    for mu in found[1:]:
        merged = jax.tree_util.tree_map(lambda a, b: b if is_masked(a) else a,
                                        merged, mu, is_leaf=is_masked)
    return jax.device_get(merged)


@pytest.fixture(scope="module")
def runs():
    vae_cfg_j = JaxVAEConfig(**TINY_VAE)
    cfg_j = JaxTrainConfig(**TRAIN)
    x0 = jnp.zeros((1, 32, 32, 3))
    vae_j = JaxVAE(cfg=vae_cfg_j)
    g_params = randomize_params(
        vae_j.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                   x0)["params"], 0)
    disc_j = JaxDisc()
    d_params = randomize_params(disc_j.init(jax.random.PRNGKey(1), x0)["params"], 1)
    lpips_j = JaxLPIPS()
    lpips_params = jax.device_get(lpips_j.init(jax.random.PRNGKey(2), x0, x0)["params"])
    state_j, g_tx, d_tx = jax_create_train_state(cfg_j, g_params, d_params, 32,
                                                 jax.random.PRNGKey(3))
    jstep = jax.jit(jax_make_train_step(cfg_j, vae_cfg_j, vae_j, disc_j, lpips_j, g_tx, d_tx),
                    static_argnums=(3,))

    vae_cfg = VAEConfig(**TINY_VAE)
    cfg = TrainConfig(**TRAIN)
    vae = VAE(vae_cfg)
    vae.load_state_dict(jax_params_to_state_dict(g_params), strict=True)
    disc = PatchDiscriminator()
    disc.load_state_dict(jax_disc_params_to_state_dict(d_params), strict=True)
    lpips = LPIPS()
    lpips.load_state_dict(jax_lpips_params_to_state_dict(lpips_params), strict=True)
    state = create_train_state(cfg, vae, disc, vae_cfg.ch, seed=0)
    step = make_train_step(cfg, vae_cfg, vae, disc, lpips)

    rng = np.random.RandomState(5)
    out = {"jax": [], "port": [], "d_grads_none": []}
    jrng = state_j.rng
    z_side = 16
    crop_side = int(round(cfg.crop_fractions[CROP_BUCKET - 1] * z_side))
    for i, do_crop in enumerate((0, 0, 0, CROP_BUCKET)):
        batch = rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
        draws, jrng = _jax_draws(jrng, z_side, crop_side)
        state_j, m_j = jstep(state_j, jnp.asarray(batch), lpips_params, do_crop)
        state, m = step(state, torch.from_numpy(batch), do_crop, draws)
        out["jax"].append({k: float(v) for k, v in m_j.items()})
        out["port"].append({k: float(v) for k, v in m.items()})
        out["d_grads_none"].append(all(p.grad is None for p in disc.parameters()))
        if i == 0:
            out["mu_g"] = jax_params_to_state_dict(_mu_tree(state_j.g_opt))
            out["mu_d"] = jax_disc_params_to_state_dict(_mu_tree(state_j.d_opt))
            out["exp_avg_g"] = {n: state.g_opt.state[p]["exp_avg"].clone()
                                for n, p in vae.named_parameters()}
            out["exp_avg_d"] = {n: state.d_opt.state[p]["exp_avg"].clone()
                                for n, p in disc.named_parameters()}
        if i == 1:
            out["ema_jax"] = jax_params_to_state_dict(jax.device_get(state_j.g_ema))
            out["ema_port"] = {k: v.clone() for k, v in state.g_ema.items()}
            out["params_jax"] = jax_params_to_state_dict(jax.device_get(state_j.g_params))
            out["params_port"] = {k: v.detach().clone() for k, v in vae.named_parameters()}
    out["params_init"] = {k: v.clone() for k, v in jax_params_to_state_dict(g_params).items()}
    out["state"] = state
    out["draws"] = draws
    return out


def _lpips(generator):
    lpips = LPIPS()
    init_lpips_(lpips, generator)
    return lpips


def _check_tensors(got: dict, ref: dict, rtol: float, atol: float):
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = r.numpy()
        scale = np.abs(r).max()
        err = np.abs(got[k].numpy() - r).max()
        assert err <= rtol * scale + atol, (k, err, scale)


def test_step1_gradients_match_jax(runs):
    for side in ("g", "d"):
        ref = runs[f"mu_{side}"]
        floor = ZERO_FLOOR * max(float(r.abs().max()) for r in ref.values())
        _check_tensors(runs[f"exp_avg_{side}"], ref, GRAD_RTOL, floor)
    # G's gradient has all three parts (LPIPS and GAN branches through
    # GradNorm, the z regularizer through the clamp): no tensor of a level
    # wider than one channel per group is zero
    nonzero = [k for k, v in runs["exp_avg_g"].items() if float(v.abs().max()) > 1e-6]
    assert len(nonzero) == len(runs["exp_avg_g"]) - 6


@pytest.mark.parametrize("i", [0, 1, 2])
def test_metric_curve_matches_jax(runs, i):
    ref, got = runs["jax"][i], runs["port"][i]
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                   err_msg=f"step {i} {k}")


def test_gaussian_step_draws_eps_on_the_state_generator():
    """Without given draws the step draws ε on the state's generator, in the
    encoder's dtype: two states seeded alike take equal steps; given draws
    without ε raise."""
    vae_cfg = VAEConfig(**{**TINY_VAE, "reg_type": "gaussian"})
    cfg = TrainConfig(**{**TRAIN, "do_ganloss": False})
    batch = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3))
                             .astype(np.float32))
    out = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        vae = init_vae(vae_cfg, gen)
        state = create_train_state(cfg, vae, None, vae_cfg.ch, seed=7)
        step = make_train_step(cfg, vae_cfg, vae, None, _lpips(gen))
        for _ in range(2):
            state, m = step(state, batch)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.detach().clone() for k, v in vae.state_dict().items()}))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(v, out[1][1][k]) for k, v in out[0][1].items())
    with pytest.raises(ValueError, match="eps"):
        step(state, batch, 0, StepDraws(False, False, False, 0, 0, False, False))


def test_metric_curve_moves(runs):
    first, last = runs["port"][0], runs["port"][2]
    assert first["overall_vae_loss"] != pytest.approx(last["overall_vae_loss"], rel=1e-6)
    assert first["gan/discriminator_loss"] != pytest.approx(
        last["gan/discriminator_loss"], rel=1e-6)


def test_crop_bucket_step_matches_jax(runs):
    ref, got = runs["jax"][3], runs["port"][3]
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL, err_msg=k)


def test_discriminator_takes_no_gradient_from_the_generator_backward(runs):
    """D's grads are cleared after its own update; the G backward (which runs
    through D for the GAN branch) leaves them unset."""
    assert all(runs["d_grads_none"])


def test_ema_matches_jax(runs):
    """ema_decay 0.5 after two steps. The step-0 lr is 0, so the EMA is
    d·p0 + (1 - d)·p2 of the port's own params, exactly. Against the JAX
    state's g_ema: AdamW's second update is at most lr_1 = 5e-4 per entry on
    either side (|m̂|/√v̂ <= 1 at step 2 with betas 0.9, 0.95), so where a
    gradient's sign is noise the params differ by up to 2·lr_1 and the EMA by
    (1 - d)·2·lr_1 (measured 4.2e-4 against the bound 5e-4)."""
    decay = TRAIN["ema_decay"]
    lr_1 = 0.5 * TRAIN["learning_rate_vae"] / TINY_VAE["ch"]
    for k, ema in runs["ema_port"].items():
        p0, p2 = runs["params_init"][k], runs["params_port"][k]
        torch.testing.assert_close(ema, decay * p0 + (1 - decay) * p2, atol=1e-7, rtol=1e-6)
        bound = (1 - decay) * 2 * lr_1 + 1e-6
        assert float((ema - runs["ema_jax"][k]).abs().max()) <= bound, k
    lag = max(float((runs["ema_port"][k] - runs["params_port"][k]).abs().max())
              for k in runs["ema_port"])
    assert lag > 0


def test_generator_sees_the_updated_discriminator():
    """At a visible D lr: D moves in step 1 and G does not (its lr is 0 at
    step 0); the step's G GAN loss is −mean(D(recon)) for the UPDATED D, and
    not for the D it started from."""
    vae_cfg = VAEConfig(**TINY_VAE)
    cfg = TrainConfig(**{**TRAIN, "learning_rate_disc": 1e-3, "flip_invariance": False})
    gen = torch.Generator().manual_seed(1)
    vae = init_vae(vae_cfg, gen)
    disc = PatchDiscriminator()
    init_discriminator_(disc, gen)
    with torch.no_grad():  # non-zero final heads, so D's update reaches the logits
        for k in range(1, 6):
            head = getattr(disc, f"binary_classifier{k}")[-1]
            head.weight.normal_(0.0, 0.05, generator=gen)
    state = create_train_state(cfg, vae, disc, vae_cfg.ch)
    step = make_train_step(cfg, vae_cfg, vae, disc, _lpips(gen))
    batch = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, 32, 32, 3))
                             .astype(np.float32))
    no_flips = StepDraws(False, False, False, 0, 0, False, False)
    g0 = {k: v.clone() for k, v in vae.state_dict().items()}
    d0 = {k: v.clone() for k, v in disc.state_dict().items()}
    state, m = step(state, batch, 0, no_flips)
    assert all(torch.equal(v, g0[k]) for k, v in vae.state_dict().items())
    assert any(not torch.equal(v, d0[k]) for k, v in disc.state_dict().items())
    with torch.no_grad():
        recon = vae.decode(vae.encode(batch).clamp(-8, 8)).float()
        after = float(-disc(recon).mean())
        disc.load_state_dict(d0)
        before = float(-disc(recon).mean())
    np.testing.assert_allclose(float(m["gan/generator_gan_loss"]), after, rtol=1e-5, atol=1e-7)
    assert abs(after - before) > 100 * abs(float(m["gan/generator_gan_loss"]) - after)


def test_lr_groups_and_schedule_match_jax():
    cfg = TrainConfig(**TRAIN)
    vae = VAE(VAEConfig(**TINY_VAE))
    state = create_train_state(cfg, vae, PatchDiscriminator(), 32)
    conv_in = {id(p) for p in state.g_opt.param_groups[1]["params"]}
    names = {n for n, p in vae.named_parameters() if id(p) in conv_in}
    assert names == {"encoder.conv_in.weight", "encoder.conv_in.bias",
                     "decoder.conv_in.weight", "decoder.conv_in.bias"}
    rest = jax_hf_cosine_schedule(cfg.learning_rate_vae / 32, cfg.warmup_steps, cfg.max_steps)
    conv = jax_hf_cosine_schedule(1e-4, cfg.warmup_steps, cfg.max_steps)
    for s in range(cfg.max_steps + 2):
        lrs = [g["lr"] for g in state.g_opt.param_groups]
        # the JAX schedule computes in float32 (measured 1.2e-6 relative)
        np.testing.assert_allclose(lrs, [float(rest(s)), float(conv(s))], rtol=1e-5,
                                   atol=1e-12, err_msg=f"step {s}")
        state.g_opt.step()  # no grads: moves nothing
        state.g_sched.step()
    for group in state.g_opt.param_groups + state.d_opt.param_groups:
        assert group["betas"] == (cfg.beta1, cfg.beta2)
        assert group["weight_decay"] == cfg.weight_decay and group["eps"] == 1e-8
    assert state.d_opt.param_groups[0]["lr"] == cfg.learning_rate_disc
    fn = hf_cosine_schedule(1.0, 10, 100)
    assert fn(0) == 0.0 and fn(10) == 1.0
    np.testing.assert_allclose([fn(5), fn(100)], [0.5, 0.0], atol=1e-12)


def test_one_generator_forward_and_backward_per_step(monkeypatch):
    """Every GroupNorm of the VAE runs once forward and once backward per
    step: the D update reuses recon.detach(), the G losses the same graph."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = groupnorm_cuda.group_norm_forward, groupnorm_cuda.group_norm_backward

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(groupnorm_cuda, "group_norm_forward", count("fwd", fwd))
    monkeypatch.setattr(groupnorm_cuda, "group_norm_backward", count("bwd", bwd))
    vae_cfg = VAEConfig(**TINY_VAE)
    cfg = TrainConfig(**TRAIN)
    gen = torch.Generator().manual_seed(0)
    vae = init_vae(vae_cfg, gen)
    disc = PatchDiscriminator()
    init_discriminator_(disc, gen)
    state = create_train_state(cfg, vae, disc, 32)
    step = make_train_step(cfg, vae_cfg, vae, disc, _lpips(gen))
    n_gn = sum(type(m).__name__ == "FP32GroupNorm" for m in vae.modules())
    batch = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 32, 32, 3), np.uint8))
    state, m = step(state, batch)  # uint8, drawn coins and offsets
    assert calls == {"fwd": n_gn, "bwd": n_gn}
    assert state.step == 1 and all(np.isfinite(float(v)) for v in m.values())
    calls.update(fwd=0, bwd=0)
    step(state, batch, do_crop=CROP_BUCKET)
    assert calls == {"fwd": n_gn, "bwd": n_gn}


def test_z_statistics_population_moments():
    z = torch.from_numpy(np.random.RandomState(1).randn(2, 4, 4, 8).astype(np.float32) * 2)
    got = z_statistics(z)
    zf = z.numpy().reshape(-1).astype(np.float64)
    c = zf - zf.mean()
    std = zf.std()  # ddof 0
    np.testing.assert_allclose(float(got["z_quantiles/kurtosis"]), (c ** 4).mean() / std ** 4,
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["z_quantiles/skewness"]), (c ** 3).mean() / std ** 3,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(
        [float(got[f"z_quantiles/{q:.1f}"]) for q in (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)],
        np.quantile(zf, [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]), rtol=1e-6)


@pytest.mark.parametrize("kw,what", [
    ({"gradnorm_mode": "bogus"}, "gradnorm_mode"),
])
def test_unported_options_raise(kw, what):
    vae_cfg = VAEConfig(**TINY_VAE)
    cfg = dataclasses.replace(TrainConfig(**TRAIN), **kw)
    with pytest.raises((NotImplementedError, ValueError), match=what):
        make_train_step(cfg, vae_cfg, VAE(vae_cfg), PatchDiscriminator(), LPIPS())
    g_cfg = VAEConfig(**{**TINY_VAE, "reg_type": "gaussian"})
    with pytest.raises((NotImplementedError, ValueError), match=what):
        make_train_step(cfg, g_cfg, VAE(g_cfg), PatchDiscriminator(), LPIPS())


def test_train_config_has_every_jax_field_with_its_default():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert port_fields == jax_fields


@pytest.mark.parametrize("recon_weight,branches", [(0.0, 2), (0.5, 3)])
def test_gradnorm_branches_take_gradient(monkeypatch, recon_weight, branches):
    """GradNorm is applied three times to recon; with recon_weight 0 the MSE
    branch's loss does not use it, so only the LPIPS and GAN branches run a
    GradNorm backward, as in the JAX step."""
    from vqgan_tpu_torch.ops import gradnorm as gradnorm_mod

    calls = []
    backward = gradnorm_mod.GradNorm.backward

    def counted(ctx, g):
        calls.append(ctx.weight)
        return backward(ctx, g)

    monkeypatch.setattr(gradnorm_mod.GradNorm, "backward", staticmethod(counted))
    vae_cfg = VAEConfig(**TINY_VAE)
    cfg = TrainConfig(**{**TRAIN, "recon_weight": recon_weight})
    gen = torch.Generator().manual_seed(3)
    vae = init_vae(vae_cfg, gen)
    disc = PatchDiscriminator()
    init_discriminator_(disc, gen)
    state = create_train_state(cfg, vae, disc, 32)
    step = make_train_step(cfg, vae_cfg, vae, disc, _lpips(gen))
    batch = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3))
                             .astype(np.float32))
    step(state, batch, 0, StepDraws(False, False, False, 0, 0, False, False))
    assert len(calls) == branches
    expect = {cfg.gradnorm_lpips, cfg.gradnorm_gan}
    if recon_weight:
        expect.add(cfg.gradnorm_mse)
    assert set(calls) == expect
