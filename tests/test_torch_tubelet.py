"""The port's ``TubeletDiscriminator`` against the flax module of
``vqgan_tpu/losses/discriminator.py``, on the CPU, and the 3D GAN step with
the VQ latent and the tubelet discriminator against the JAX step (through
tests/test_torch_step3d.py's harness: 3 of 4 frames per step, so the
temporal kernel is min(3, 3) = 3).

Params come from ``jax.eval_shape`` filled by numpy, the temporal mixers'
(kt, 1, 1, 1, C) kernels included; they reach the port through
``jax_disc_params_to_state_dict`` as (C, 1, kt, 1, 1) weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.losses.discriminator import TubeletDiscriminator as JaxTubelet
from vqgan_tpu.losses.discriminator import _identity_temporal_init
from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
from vqgan_tpu_torch.losses.discriminator import (
    PatchDiscriminator,
    TubeletDiscriminator,
    init_discriminator_,
)
from vqgan_tpu_torch.models.tae import TVAE
from vqgan_tpu_torch.train.state import create_train_state
from vqgan_tpu_torch.weights import jax_disc_params_to_state_dict

from test_torch_step3d import (
    GAN_KEYS,
    STEPS,
    TINY,
    TRAIN,
    VQ,
    check_curve,
    check_gradients,
    check_vq_statistics,
    run_gan,
)
from torch_parity import randomize_params

# fp32 VGG16 convs in other summation orders (XLA against oneDNN), then the
# heads' sums over patches: the 2D discriminator's bound in
# tests/test_torch_losses.py
ATOL_LOGITS = 1e-4


def _jax_tubelet(t, seed=1):
    disc_j = JaxTubelet()
    x0 = jnp.zeros((1, t, 16, 16, 3))
    params = randomize_params(jax.eval_shape(disc_j.init, jax.random.PRNGKey(0), x0)["params"],
                              seed)
    return disc_j, params


@pytest.mark.parametrize("t", [2, 3])
def test_tubelet_matches_jax(t):
    """T = 2 (kt = 2: SAME pads (0, 1) frames, the "center" tap is the
    later frame) and T = 3 (kt = 3), random temporal kernels; (B, T·P)
    logits."""
    disc_j, params = _jax_tubelet(t)
    x = np.random.RandomState(t).uniform(-1, 1, (2, t, 16, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(disc_j.apply)({"params": params}, jnp.asarray(x)))
    disc = TubeletDiscriminator(t)
    disc.load_state_dict(jax_disc_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = disc(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, t) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL_LOGITS, rtol=1e-5)


def test_tmix_weight_transposes_to_depthwise_conv3d():
    """The JAX (kt, 1, 1, 1, C) kernel entry [dt, 0, 0, 0, c] is torch's
    (C, 1, kt, 1, 1) entry [c, 0, dt, 0, 0]."""
    _, params = _jax_tubelet(3)
    sd = jax_disc_params_to_state_dict(params)
    for k, c in enumerate((64, 128, 256, 512, 512), start=1):
        kernel = params[f"tmix{k}"]["kernel"]
        assert kernel.shape == (3, 1, 1, 1, c) and sd[f"tmix{k}.weight"].shape == (c, 1, 3, 1, 1)
        np.testing.assert_array_equal(sd[f"tmix{k}.weight"][:, 0, :, 0, 0].numpy(),
                                      kernel[:, 0, 0, 0, :].T)


def test_tubelet_at_init_is_the_frame_discriminator():
    """Identity-initialized mixers (only the center tap, 1, as the JAX
    module's kernel init): at T = 3 the tubelet disc's logits are the
    per-frame PatchDiscriminator's, frame by frame, with the same backbone
    and heads."""
    for kt in (2, 3):  # the JAX kernel init: only the tap kt // 2 is 1
        np.testing.assert_array_equal(
            np.asarray(_identity_temporal_init(None, (kt, 1, 1, 1, 4)))[:, 0, 0, 0, :],
            np.eye(kt)[kt // 2][:, None].repeat(4, 1))
    gen = torch.Generator().manual_seed(0)
    tubelet = TubeletDiscriminator(3)
    init_discriminator_(tubelet, gen)
    for k in range(1, 6):
        w = getattr(tubelet, f"tmix{k}").weight
        assert torch.equal(w[:, 0, :, 0, 0], torch.tensor([0.0, 1.0, 0.0]).expand(w.shape[0], 3))
    with torch.no_grad():  # non-zero final heads, so the logits are not all biases
        for k in range(1, 6):
            getattr(tubelet, f"binary_classifier{k}")[-1].weight.normal_(0.0, 0.05, generator=gen)
    frame = PatchDiscriminator()
    sd = {n: v for n, v in tubelet.state_dict().items() if not n.startswith("tmix")}
    frame.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, 3, 16, 16, 3))
                         .astype(np.float32))
    with torch.no_grad():
        got = tubelet(x)
        ref = frame(x.reshape(6, 16, 16, 3)).reshape(2, -1)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_create_train_state_takes_a_tvae_and_a_tubelet_disc():
    """Per-rank memory formats: the TVAE's and the tmix 5-D weights
    channels_last_3d, D's 4-D convs channels_last; every parameter in its
    optimizer. The recon-only state: one constant-lr group, no schedule, no
    D, no Polyak EMA."""
    tvae_cfg = TVAEConfig(**TINY)
    cfg = TrainConfig(**{**TRAIN, "disc_3d": "tubelet"})
    model, disc = TVAE(tvae_cfg), TubeletDiscriminator(3)
    state = create_train_state(cfg, model, disc, tvae_cfg.ch)
    for m in (model, disc):
        for name, p in m.named_parameters():
            if p.ndim == 5:
                assert p.is_contiguous(memory_format=torch.channels_last_3d), name
            if p.ndim == 4:
                assert p.is_contiguous(memory_format=torch.channels_last), name
    assert sum(1 for p in disc.parameters() if p.ndim == 5) == 5
    assert sum(1 for p in model.parameters() if p.ndim == 5) > 0
    for opt, m in ((state.g_opt, model), (state.d_opt, disc)):
        held = {id(p) for g in opt.param_groups for p in g["params"]}
        assert held == {id(p) for p in m.parameters()}
    assert len(state.g_opt.param_groups) == 2 and state.g_sched is not None
    recon = create_train_state(cfg, TVAE(tvae_cfg), None, tvae_cfg.ch, recon_only=True)
    assert [g["lr"] for g in recon.g_opt.param_groups] == [cfg.learning_rate_vae / tvae_cfg.ch]
    assert recon.g_sched is None and recon.d_opt is None and recon.g_ema is None
    with pytest.raises(ValueError, match="recon_only"):
        create_train_state(cfg, TVAE(tvae_cfg), disc, tvae_cfg.ch, recon_only=True)


@pytest.fixture(scope="module")
def gan_vq_tubelet():
    return run_gan({**TINY, **VQ}, "tubelet")


@pytest.mark.parametrize("side", ["g", "d"])
def test_gan_vq_tubelet_step1_gradients_match_jax(gan_vq_tubelet, side):
    check_gradients(gan_vq_tubelet, side, vq_ema=True)


@pytest.mark.parametrize("i", range(STEPS))
def test_gan_vq_tubelet_curve_matches_jax(gan_vq_tubelet, i):
    check_curve(gan_vq_tubelet, i, GAN_KEYS)


@pytest.mark.parametrize("i", [0, STEPS - 1])
def test_gan_vq_tubelet_statistics_match_jax(gan_vq_tubelet, i):
    check_vq_statistics(gan_vq_tubelet, i)
