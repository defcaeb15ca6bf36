"""The port's microbatched 3D train steps, on the CPU.

The GAN step with the VQ latent (EMA, revival) and the frame discriminator at
``grad_accum=2`` (batch 2, so microbatches of 1 clip) against the JAX
package's ``step_accum`` (``vqgan_tpu/train/step3d.py:333-494``) for two
steps, through tests/test_torch_step3d.py's harness and bounds: step-1 first
moments of G and D, the metric curve, the EMA counts to one token. JAX's D
pass quantizes without statistics (``gen_forward_nostats``), so the
statistics advance once a microbatch, in G's pass, on both sides.

Then port only: the recon-only step with the Gaussian latent at
``grad_accum=2`` is the step at ``grad_accum=1`` on the same clips and ε, to
rounding (every loss is a per-clip mean and GroupNorm is per clip, so the
mean of the microbatches' gradients is the whole batch's); and the GAN step
at ``grad_accum=2`` with ``remat`` (the model's regions, LPIPS and D) is
bitwise the step without.
"""

import numpy as np
import pytest
import torch

from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator, init_discriminator_
from vqgan_tpu_torch.losses.lpips import LPIPS, init_lpips_
from vqgan_tpu_torch.models.tae import init_tvae
from vqgan_tpu_torch.train.state import create_train_state
from vqgan_tpu_torch.train.step3d import Step3DDraws, make_train_step_3d, make_train_step_3d_gan

from test_torch_step3d import (
    BATCH,
    FRAMES,
    GAN_KEYS,
    RES,
    TINY,
    TRAIN,
    VQ,
    check_curve,
    check_gradients,
    check_vq_statistics,
    run_gan,
)

ACCUM, STEPS = 2, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def gan_vq_accum():
    return run_gan({**TINY, **VQ}, "frame", steps=STEPS, grad_accum=ACCUM)


@pytest.mark.parametrize("side", ["g", "d"])
def test_accum_vq_step1_gradients_match_jax(gan_vq_accum, side):
    check_gradients(gan_vq_accum, side, vq_ema=True)


@pytest.mark.parametrize("i", range(STEPS))
def test_accum_vq_curve_matches_jax(gan_vq_accum, i):
    check_curve(gan_vq_accum, i, GAN_KEYS)


@pytest.mark.parametrize("i", range(STEPS))
def test_accum_vq_statistics_match_jax(gan_vq_accum, i):
    check_vq_statistics(gan_vq_accum, i)


def _clips(seed=3, batch=BATCH):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (batch, FRAMES, RES, RES, 3))
                            .astype(np.float32))


def test_recon_accum_is_the_whole_batch_step():
    """One recon-only step at accum 2 and at accum 1 from the same weights,
    clips and ε: the losses and AdamW's first moments ((1 − β1)·gradient) to
    rounding."""
    clips = _clips(batch=4)
    eps = torch.randn(4, 2, 8, 8, 8, generator=torch.Generator().manual_seed(4))
    out = {}
    for accum in (1, ACCUM):
        cfg = TrainConfig(**{**TRAIN, "do_ganloss": False, "batch_size": 4,
                             "grad_accum": accum})
        model = init_tvae(TVAEConfig(**TINY), torch.Generator().manual_seed(0))
        state = create_train_state(cfg, model, None, TINY["ch"], recon_only=True)
        step = make_train_step_3d(cfg, TVAEConfig(**TINY), model)
        draws = Step3DDraws(eps=eps)
        _, m = step(state, clips, draws)
        assert draws.eps is eps
        out[accum] = ({k: float(v) for k, v in m.items()},
                      {n: state.g_opt.state[p]["exp_avg"] for n, p in model.named_parameters()})
    (m1, g1), (m2, g2) = out[1], out[ACCUM]
    assert set(m1) == set(m2) == {"recon_l2", "kl", "loss"}
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=1e-6, err_msg=k)
    scale = max(float(g.abs().max()) for g in g1.values())
    for name, g in g1.items():
        assert float((g2[name] - g).abs().max()) <= 1e-5 * float(g.abs().max()) + 1e-7 * scale, \
            name


def test_recon_accum_draws_epsilon_a_microbatch_at_a_time():
    """Without given ε the accumulated step draws each microbatch's on the
    state's generator and hands the whole batch's back in the draws."""
    cfg = TrainConfig(**{**TRAIN, "do_ganloss": False, "grad_accum": ACCUM})
    model = init_tvae(TVAEConfig(**TINY), torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, None, TINY["ch"], recon_only=True, seed=9)
    draws = Step3DDraws()
    make_train_step_3d(cfg, TVAEConfig(**TINY), model)(state, _clips(), draws)
    gen = torch.Generator().manual_seed(9)
    want = torch.cat([torch.randn(1, 2, 8, 8, 8, generator=gen) for _ in range(ACCUM)])
    assert torch.equal(draws.eps, want)


def _gan_run(remat, policy):
    tvae_cfg = TVAEConfig(**TINY, remat=remat, remat_policy=policy)
    cfg = TrainConfig(**{**TRAIN, "grad_accum": ACCUM})
    gen = torch.Generator().manual_seed(0)
    model = init_tvae(tvae_cfg, gen)
    disc, lpips = PatchDiscriminator(), LPIPS()
    init_discriminator_(disc, gen)
    init_lpips_(lpips, gen)
    state = create_train_state(cfg, model, disc, TINY["ch"], seed=1)
    step = make_train_step_3d_gan(cfg, tvae_cfg, model, disc, lpips)
    _, m = step(state, _clips())
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {k: float(v) for k, v in m.items()}, params


def test_gan_accum_with_remat_is_bitwise():
    """One step with remat "full" (tests/test_torch_remat.py holds both
    policies on the model): metrics and weights bitwise the step without."""
    ref_m, ref_p = _gan_run(False, "full")
    m, p = _gan_run(True, "full")
    assert m == ref_m
    assert all(torch.equal(v, ref_p[n]) for n, v in p.items())
