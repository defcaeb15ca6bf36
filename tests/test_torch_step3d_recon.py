"""The port's recon-only 3D step (``make_train_step_3d``) against the JAX
package's (``vqgan_tpu/train/trainer3d.py::make_train_step_3d``), on the
CPU, through tests/test_torch_step3d.py's harness: the tiny TVAE, the JAX
step's draws (``rng, sub, k_revive = split(rng, 3)``), one constant-lr AdamW
at learning_rate_vae / ch on both sides. Gaussian (L2 + z_reg_weight·KL) and
VQ with EMA 0.9 and dead-code revival at 0.5 (L2 + z_reg_weight·vq_loss).
"""

import pytest

from test_torch_step3d import (
    RECON_KEYS,
    STEPS,
    TINY,
    VQ,
    check_curve,
    check_gradients,
    check_vq_statistics,
    run_recon_only,
)


@pytest.fixture(scope="module")
def recon_gaussian():
    return run_recon_only(TINY)


@pytest.fixture(scope="module")
def recon_vq():
    return run_recon_only({**TINY, **VQ})


def test_recon_only_gaussian_step1_gradients_match_jax(recon_gaussian):
    check_gradients(recon_gaussian)


@pytest.mark.parametrize("i", range(STEPS))
def test_recon_only_gaussian_curve_matches_jax(recon_gaussian, i):
    check_curve(recon_gaussian, i, RECON_KEYS)


def test_recon_only_vq_step1_gradients_match_jax(recon_vq):
    check_gradients(recon_vq, vq_ema=True)


@pytest.mark.parametrize("i", range(STEPS))
def test_recon_only_vq_curve_matches_jax(recon_vq, i):
    check_curve(recon_vq, i, RECON_KEYS)


@pytest.mark.parametrize("i", [0, STEPS - 1])
def test_recon_only_vq_statistics_match_jax(recon_vq, i):
    check_vq_statistics(recon_vq, i)
