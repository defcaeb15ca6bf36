"""The slice as a whole: the JAX package's ``Trainer`` and the port's
``Trainer`` (on the CPU) run the same 3-step job on synthetic data.

Both get the same ``--load_path`` .pt (written by the JAX package's
``save_weights_torch`` from seeded params) and the same ``--lpips_weights``
.npz; the latent is the sampled Gaussian, with clamp, flip and crop
invariance. The GAN loss is off: D's heads start from each package's own
init, which no flag shares. The port takes the JAX step's draws (its coins,
crop offsets and ε, derived from the JAX state's key as
``tests/test_torch_train_step.py`` does), so their logged losses agree
within that file's bounds; their JSONL lines carry the same keys, and their
crop coins (``np.random.default_rng(seed)``, in the same order) pick the
same buckets. The seed's coins crop every step in bucket 3, so the JAX
trainer compiles one step variant (the no-crop step is held against JAX in
tests/test_torch_train_step.py); eval is off (held against JAX in
tests/test_torch_eval_metrics.py): the suite's time is tight.
"""

import json

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.train.checkpoint import save_weights_torch as jax_save_weights_torch
from vqgan_tpu.train.trainer import Trainer as JaxTrainer
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.train.trainer import Trainer

from test_torch_train_step import CURVE_ATOL, CURVE_RTOL, _jax_draws, jax_eps_sampler
from torch_parity import randomize_params

TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            enc_dtype="float32", dec_dtype="float32", reg_type="gaussian")
STEPS = 3
# host-clock keys: the same names on both sides, values of their own
CLOCK_KEYS = {"time_taken_till_step", "time_taken_till_load"}


def _job(tmp_path, **kw):
    return dict(synthetic_data=True, batch_size=8, image_size=32, max_steps=STEPS,
                num_epochs=1, evaluate_every_n_steps=0, seed=319, use_wandb=False,
                log_every=1, run_name="p", warmup_steps=2, learning_rate_vae=0.032,
                do_clamp=True, clamp_th=1.0, flip_invariance=True, crop_invariance=True,
                downscale_factor=2, **kw)


def _lines(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _recording(step_fn, buckets, at):
    """``step_fn`` that records its crop bucket, its ``at``-th argument
    after the batch."""
    def step(state, batch, *args):
        buckets.append(int(args[at]))
        return step_fn(state, batch, *args)
    return step


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainers")
    x0 = jnp.zeros((1, 32, 32, 3))
    vae_j = JaxVAE(cfg=JaxVAEConfig(**TINY))
    g_params = randomize_params(jax.eval_shape(
        vae_j.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        x0)["params"], 11)
    pt = str(tmp / "g.pt")
    jax_save_weights_torch(g_params, pt)
    lp = randomize_params(jax.eval_shape(JaxLPIPS().init, jax.random.PRNGKey(2), x0,
                                         x0)["params"], 12)
    npz = str(tmp / "lpips.npz")
    np.savez(npz, **{f"vgg/{c}/{leaf}": v for c, conv in lp["vgg"].items()
                     for leaf, v in conv.items()},
             **{f"lin_{k}": np.abs(lp[f"lin_{k}"]) for k in range(5)})
    files = dict(load_path=pt, lpips_weights=npz)

    # the JAX trainer; its flax inits jitted (one compile each, not one per
    # op): the params they make are replaced by the files' anyway
    init = flax_nn.Module.init

    def jitted_init(self, rngs, *args, **kwargs):
        return jax.jit(lambda r, *a: init(self, r, *a, **kwargs))(rngs, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Module, "init", jitted_init)
        jt = JaxTrainer(JaxTrainConfig(**_job(tmp, ckpt_dir=str(tmp / "jax"), **files)),
                        JaxVAEConfig(**TINY))
    rng = jnp.asarray(np.asarray(jt.state.rng))  # a copy: train() donates the state
    out = {"jax_buckets": [], "port_buckets": []}
    jt._step = _recording(jt._step, out["jax_buckets"], 1)  # (lpips_params, do_crop)
    jt.train()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pt_trainer = Trainer(TrainConfig(**_job(tmp, ckpt_dir=str(tmp / "port"), **files)),
                             VAEConfig(**TINY), device="cpu")
        sample = jax_eps_sampler(vae_j, g_params, (8, 16, 16, TINY["z_channels"]))
        cfg = pt_trainer.cfg

        real_step = pt_trainer._step

        def jax_drawn_step(state, batch, do_crop=0, draws=None):
            """The port's step fed the JAX step's draws for this bucket."""
            nonlocal rng
            side = int(round(cfg.crop_fractions[do_crop - 1] * 16)) if do_crop else 16
            draws, rng = _jax_draws(rng, 16, side, sample)
            return real_step(state, batch, do_crop, draws)

        pt_trainer._step = _recording(jax_drawn_step, out["port_buckets"], 0)  # (do_crop,)
        pt_trainer.train()
    finally:
        torch.set_num_threads(threads)
    out["jax"] = _lines(tmp / "jax" / "p" / "metrics_p.jsonl")
    out["port"] = _lines(tmp / "port" / "p" / "metrics_p.jsonl")
    return out


def test_crop_buckets_are_the_same(runs):
    assert runs["jax_buckets"] == [3] * STEPS
    assert runs["port_buckets"] == runs["jax_buckets"]


def test_jsonl_keys_are_the_same(runs):
    jax_lines, port_lines = runs["jax"], runs["port"]
    assert set(port_lines[0]["_config"]) == set(jax_lines[0]["_config"])
    assert [set(ln) for ln in port_lines[1:]] == [set(ln) for ln in jax_lines[1:]]
    assert [ln["step"] for ln in port_lines if "overall_vae_loss" in ln] == list(range(STEPS))
    assert any("loss_stepwise/overall_vae_loss_0" in ln for ln in port_lines)


@pytest.mark.parametrize("step", range(STEPS))
def test_logged_losses_match_jax(runs, step):
    ref = next(ln for ln in runs["jax"] if ln.get("step") == step and "overall_vae_loss" in ln)
    got = next(ln for ln in runs["port"] if ln.get("step") == step and "overall_vae_loss" in ln)
    for k, v in ref.items():
        if k not in CLOCK_KEYS:
            np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                       err_msg=f"step {step} {k}")
