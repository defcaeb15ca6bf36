"""The port's GAN train step with the VQ latent against the JAX package's, on
the CPU.

The harness and tolerances are tests/test_torch_train_step.py's: the same
``TINY_VAE`` and ``TRAIN`` configs (hinge + LeCam + clamp + flip invariance,
fp32, batch 4, D's lr 1e-8), the flax init made non-trivial with
``randomize_params``, the JAX step's own draws handed to the port's step.
The latent is ``reg_type="vq"`` with K = 32 codes (tests/test_train_step.py:
215-256): EMA 0.9 with dead-code revival at 0.5 over three steps, the K
revival rows drawn from the JAX step's key (``keys[7]``); and one step of the
loss-based codebook (EMA 0).

The EMA counts start from a numpy draw in [0.3, 1.3) (sums = counts·codebook,
so the statistics agree with the codebook), so that codes unused in step 1
fall below the revival threshold there: 0.9·c < 0.5.
"""

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
from vqgan_tpu.train.step import make_train_step as jax_make_train_step
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.losses.discriminator import PatchDiscriminator
from vqgan_tpu_torch.losses.lpips import LPIPS
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.train.state import create_train_state
from vqgan_tpu_torch.train.step import make_train_step
from vqgan_tpu_torch.weights import (
    jax_disc_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
    jax_vq_ema_to_torch,
)

from test_torch_train_step import (
    BATCH,
    CURVE_ATOL,
    CURVE_RTOL,
    GRAD_RTOL,
    TINY_VAE,
    TRAIN,
    ZERO_FLOOR,
    _check_tensors,
    _jax_draws,
    _mu_tree,
)
from torch_parity import randomize_params

K = 32
Z_SIDE = 16
N_TOKENS = BATCH * Z_SIDE * Z_SIDE
VQ = dict(reg_type="vq", vq_codebook_size=K, vq_revive_threshold=0.5)
CB = "reg.codebook"


def _draws(rng):
    """The JAX step's draws for state.rng = ``rng`` (coins, offsets and the
    K revival rows from keys[7]), and the next rng."""
    draws, new_rng = _jax_draws(rng, Z_SIDE, Z_SIDE)
    keys = jax.random.split(jax.random.split(rng)[0], 8)
    draws.revive_idx = torch.from_numpy(
        np.asarray(jax.random.randint(keys[7], (K,), 0, N_TOKENS), np.int64))
    return draws, new_rng


def _run(ema_decay, steps):
    """Both steps from the same params, batches and draws. Returns per step
    the metrics, the generator's params, its EMA statistics and its Polyak
    EMA on both sides, and step 1's first moments."""
    vae_kw = {**TINY_VAE, **VQ, "vq_ema_decay": ema_decay}
    vae_cfg_j, cfg_j = JaxVAEConfig(**vae_kw), JaxTrainConfig(**TRAIN)
    x0 = jnp.zeros((1, 32, 32, 3))
    vae_j = JaxVAE(cfg=vae_cfg_j)
    g_params = randomize_params(
        vae_j.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
                   x0)["params"], 0)
    disc_j = JaxDisc()
    d_params = randomize_params(disc_j.init(jax.random.PRNGKey(1), x0)["params"], 1)
    lpips_j = JaxLPIPS()
    lpips_params = jax.device_get(lpips_j.init(jax.random.PRNGKey(2), x0, x0)["params"])
    vq_ema = None
    if ema_decay > 0:
        counts = np.random.RandomState(6).uniform(0.3, 1.3, K).astype(np.float32)
        vq_ema = {"reg": {"counts": counts,
                          "sums": counts[:, None] * g_params["reg"]["codebook"]}}
    state_j, g_tx, d_tx = jax_create_train_state(
        cfg_j, g_params, d_params, 32, jax.random.PRNGKey(3),
        vq_ema=None if vq_ema is None else jax.tree_util.tree_map(jnp.asarray, vq_ema))
    jstep = jax.jit(jax_make_train_step(cfg_j, vae_cfg_j, vae_j, disc_j, lpips_j, g_tx, d_tx),
                    static_argnums=(3,))

    vae_cfg, cfg = VAEConfig(**vae_kw), TrainConfig(**TRAIN)
    vae = VAE(vae_cfg)
    vae.load_state_dict(jax_params_to_state_dict(g_params), strict=True)
    disc = PatchDiscriminator()
    disc.load_state_dict(jax_disc_params_to_state_dict(d_params), strict=True)
    lpips = LPIPS()
    lpips.load_state_dict(jax_lpips_params_to_state_dict(lpips_params), strict=True)
    state = create_train_state(cfg, vae, disc, vae_cfg.ch, seed=0,
                               vq_ema=None if vq_ema is None else jax_vq_ema_to_torch(vq_ema))
    step = make_train_step(cfg, vae_cfg, vae, disc, lpips)

    rng = np.random.RandomState(5)
    out = {"jax": [], "port": [], "params_init": jax_params_to_state_dict(g_params)}
    jrng = state_j.rng
    for i in range(steps):
        batch = rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
        draws, jrng = _draws(jrng)
        state_j, m_j = jstep(state_j, jnp.asarray(batch), lpips_params, 0)
        state, m = step(state, torch.from_numpy(batch), 0, draws)
        jax_ema = (None if state_j.vq_ema is None
                   else jax_vq_ema_to_torch(jax.device_get(state_j.vq_ema)))
        port_ema = None if state.vq_ema is None else {k: v.clone() for k, v in state.vq_ema.items()}
        out["jax"].append({
            "metrics": {k: float(v) for k, v in m_j.items()},
            "params": jax_params_to_state_dict(jax.device_get(state_j.g_params)),
            "vq_ema": jax_ema,
            "g_ema": jax_params_to_state_dict(jax.device_get(state_j.g_ema)),
        })
        out["port"].append({
            "metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.detach().clone() for k, v in vae.named_parameters()},
            "vq_ema": port_ema,
            "g_ema": {k: v.clone() for k, v in state.g_ema.items()},
        })
        if i == 0:
            out["mu_g"] = jax_params_to_state_dict(_mu_tree(state_j.g_opt))
            out["exp_avg_g"] = {n: state.g_opt.state[p]["exp_avg"].clone()
                                for n, p in vae.named_parameters() if p in state.g_opt.state}
            out["revive_idx"] = draws.revive_idx
    return out


@pytest.fixture(scope="module")
def ema_runs():
    return _run(0.9, steps=3)


@pytest.fixture(scope="module")
def loss_run():
    return _run(0.0, steps=1)


def _check_step1_gradients(run, with_codebook: bool):
    ref = dict(run["mu_g"])
    if not with_codebook:
        # EMA mode: no gradient reaches the codebook. AdamW skips it (no
        # state); optax's first moment of it stays 0
        assert CB not in run["exp_avg_g"]
        assert float(ref.pop(CB).abs().max()) == 0.0
    floor = ZERO_FLOOR * max(float(r.abs().max()) for r in ref.values())
    _check_tensors(run["exp_avg_g"], ref, GRAD_RTOL, floor)


def test_vq_step1_gradients_match_jax(ema_runs):
    _check_step1_gradients(ema_runs, with_codebook=False)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_vq_metric_curve_matches_jax(ema_runs, i):
    ref, got = ema_runs["jax"][i]["metrics"], ema_runs["port"][i]["metrics"]
    assert set(got) == set(ref) and "vq_loss" in got
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                   err_msg=f"step {i} {k}")
    assert got["vq_loss"] > 0


@pytest.mark.parametrize("i", [0, 2])
def test_vq_ema_statistics_match_jax(ema_runs, i):
    """The counts are decay·c + (1 − decay)·(integer counts) of the same codes
    on both sides, up to the rounding of the two frameworks' fp32 scalar
    products (measured 4e-6 on counts of up to a few hundred). The sums add up
    the encoder's z, whose fp32 convs differ by ~1e-6 at step 1 and by AdamW's
    sign noise after (CURVE_RTOL; measured 1.6e-7 and 2.9e-7 of the largest
    sum)."""
    ref, got = ema_runs["jax"][i]["vq_ema"], ema_runs["port"][i]["vq_ema"]
    np.testing.assert_allclose(got["counts"].numpy(), ref["counts"].numpy(), rtol=1e-6,
                               atol=0)
    scale = float(ref["sums"].abs().max())
    rtol = 1e-5 if i == 0 else CURVE_RTOL
    assert float((got["sums"] - ref["sums"]).abs().max()) <= rtol * scale


@pytest.mark.parametrize("i", [0, 2])
def test_vq_folded_codebook_matches_jax(ema_runs, i):
    """After each step the codebook is the fold of the new statistics, with
    the codes below 0.5 revived from the step's z (the JAX rows). Bounds as
    for the sums they come from."""
    ref, got = ema_runs["jax"][i]["params"][CB], ema_runs["port"][i]["params"][CB]
    rtol = 1e-5 if i == 0 else CURVE_RTOL
    assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())
    stats = ema_runs["port"][i]["vq_ema"]
    assert not torch.equal(got, ema_runs["params_init"][CB])
    if i == 0:  # revival happened in step 1 and is what the EMA alone gives
        dead = stats["counts"] < 0.5
        assert 0 < int(dead.sum()) < K


def test_vq_polyak_ema_sees_the_folded_codebook(ema_runs):
    """ema_decay 0.5: the Polyak codebook after step 1 is 0.5·c0 + 0.5·c1 of
    the folded c1, on both sides."""
    for side in ("jax", "port"):
        c0 = ema_runs["params_init"][CB]
        c1 = ema_runs[side][0]["params"][CB]
        torch.testing.assert_close(ema_runs[side][0]["g_ema"][CB], 0.5 * c0 + 0.5 * c1,
                                   atol=1e-7, rtol=1e-6)
    ref, got = ema_runs["jax"][2]["g_ema"][CB], ema_runs["port"][2]["g_ema"][CB]
    assert float((got - ref).abs().max()) <= CURVE_RTOL * float(ref.abs().max())


def test_loss_based_vq_step_matches_jax(loss_run):
    """EMA 0: the codebook is trained by its gradient (codebook + β·commitment
    loss) in AdamW's non-conv_in group, and no statistics are kept."""
    _check_step1_gradients(loss_run, with_codebook=True)
    assert float(loss_run["exp_avg_g"][CB].abs().max()) > 0
    ref, got = loss_run["jax"][0]["metrics"], loss_run["port"][0]["metrics"]
    assert set(got) == set(ref) and "vq_loss" in got
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL, err_msg=k)
    assert loss_run["port"][0]["vq_ema"] is None and loss_run["jax"][0]["vq_ema"] is None


def _tiny_vq(ema_decay=0.9, revive=0.5):
    from vqgan_tpu_torch.losses.discriminator import init_discriminator_
    from vqgan_tpu_torch.losses.lpips import init_lpips_
    from vqgan_tpu_torch.models.ae import init_vae

    vae_cfg = VAEConfig(**{**TINY_VAE, **VQ, "vq_ema_decay": ema_decay,
                           "vq_revive_threshold": revive})
    cfg = TrainConfig(**TRAIN)
    gen = torch.Generator().manual_seed(0)
    vae = init_vae(vae_cfg, gen)
    disc, lpips = PatchDiscriminator(), LPIPS()
    init_discriminator_(disc, gen)
    init_lpips_(lpips, gen)
    return cfg, vae_cfg, vae, disc, lpips


def test_train_state_starts_the_ema_statistics_as_jax():
    """counts 1 and sums = the codebook (vqgan_tpu/models/quant.py:93-98);
    none for EMA 0 or an identity latent, where passing some is an error."""
    cfg, vae_cfg, vae, disc, _ = _tiny_vq()
    state = create_train_state(cfg, vae, disc, 32)
    assert torch.equal(state.vq_ema["counts"], torch.ones(K))
    assert torch.equal(state.vq_ema["sums"], vae.reg.codebook.detach())
    assert state.vq_ema["sums"].data_ptr() != vae.reg.codebook.data_ptr()
    cfg, _, vae0, disc0, _ = _tiny_vq(ema_decay=0.0)
    assert create_train_state(cfg, vae0, disc0, 32).vq_ema is None
    with pytest.raises(ValueError, match="vq_ema"):
        create_train_state(cfg, vae0, disc0, 32, vq_ema=state.vq_ema)


def test_vq_step_draws_its_revival_rows():
    """Without given draws the step draws the K revival rows from the state's
    generator (the run is then reproducible from the seed); given draws must
    carry them."""
    from vqgan_tpu_torch.train.step import StepDraws

    batch = torch.from_numpy(np.random.RandomState(7).uniform(-1, 1, (2, 32, 32, 3))
                             .astype(np.float32))
    codebooks = []
    for _ in range(2):
        # threshold 2: the codes used by fewer than 11 of the 512 tokens
        cfg, vae_cfg, vae, disc, lpips = _tiny_vq(revive=2.0)
        state = create_train_state(cfg, vae, disc, 32, seed=3)
        step = make_train_step(cfg, vae_cfg, vae, disc, lpips)
        state, m = step(state, batch)
        assert np.isfinite(m["vq_loss"].item()) and state.step == 1
        codebooks.append(vae.reg.codebook.detach().clone())
        assert 0 < int((state.vq_ema["counts"] < 2.0).sum()) < K
    assert torch.equal(codebooks[0], codebooks[1])
    with pytest.raises(ValueError, match="revive_idx"):
        step(state, batch, 0, StepDraws(False, False, False, 0, 0, False, False))
