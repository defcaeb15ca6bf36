"""The port's ``Trainer3D`` (``vqgan_tpu_torch/train/trainer3d.py``) on the
CPU.

(a) The slice against JAX, one JAX run: the JAX package's ``Trainer3D`` and
the port's run the same recon-only Gaussian job (the tiny TVAE: ch 32,
ch_mult 1,2, 1 res block, z 4, 16 px, 4 frames, batch 2, fp32; GroupNorm's
32 groups need ch >= 32) from the same ``--load_path`` .pt, written by the
JAX package's ``save_weights_torch`` from seeded params, for 3 steps with
eval and a checkpoint every 2. The port takes the JAX step's ε, drawn from
``PRNGKey(seed + 1)`` as the JAX step splits it. Their logged losses agree
within tests/test_torch_step3d_recon.py's bounds (``CURVE_RTOL``,
``CURVE_ATOL``), their eval metrics within ``EVAL_RTOL``, and they log the
same keys and save at the same steps. The JAX trainer runs on a one-device
mesh of the 8 CPU devices (its ``data=-1`` mesh would take all 8 and refuse
batch 2), its flax init traced for its shapes alone (``load_path`` replaces
every param).

(b) Port-only checks, each held against the port's own step, which
tests/test_torch_step3d*.py holds against JAX: the GAN path and VQ with EMA
and revival run by ``train()`` equal the same steps driven by hand; D moves
in step 1 and G in step 2; ``load_path`` seeds the Polyak and VQ EMAs (a
deliberate difference from JAX); a resume restores bitwise and reads the
synthetic stream at ``seed + start``; the NaN guard halts before a
checkpoint; eval scores the Polyak weights; the unported options raise.
"""

import json
import os

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqgan_tpu.train.trainer3d as jax_trainer3d_mod
from vqgan_tpu.config import TrainConfig as JaxTrainConfig
from vqgan_tpu.config import TVAEConfig as JaxTVAEConfig
from vqgan_tpu.models.tae import TVAE as JaxTVAE
from vqgan_tpu.parallel.mesh import create_mesh
from vqgan_tpu.train.checkpoint import save_weights_torch as jax_save_weights_torch
from vqgan_tpu_torch.config import TrainConfig, TVAEConfig
from vqgan_tpu_torch.losses.metrics import psnr
from vqgan_tpu_torch.models.quant import apply_ema_codebook_update
from vqgan_tpu_torch.models.tae import TVAE, init_weights_
from vqgan_tpu_torch.train.checkpoint import state_dict_of
from vqgan_tpu_torch.train.step3d import Step3DDraws, flat_frames
from vqgan_tpu_torch.train.trainer import DivergenceError
from vqgan_tpu_torch.train.trainer3d import (
    EVAL_SEED_OFFSET,
    Trainer3D,
    synthetic_video_batches,
)
from vqgan_tpu_torch.weights import load_weights, save_weights

from test_torch_train_step import CURVE_ATOL, CURVE_RTOL
from torch_parity import randomize_params

TINY = dict(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4,
            compute_dtype="float32")
BATCH, FRAMES = 2, 4
LATENT = (BATCH, 2, 8, 8, 4)  # the Gaussian's mean after the one downsample
STEPS = 3
SEED = 42
# eval metrics of two implementations' weights after 3 steps, fp32
EVAL_RTOL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _job(**kw):
    return dict(batch_size=BATCH, synthetic_data=True, max_steps=STEPS, use_wandb=False,
                log_every=1, evaluate_every_n_steps=2, eval_batches=1, seed=SEED,
                learning_rate_vae=0.032, run_name="r", **kw)


def _lines(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _recording(fn, into):
    """``fn`` that records its first argument."""
    def wrapped(self, step, *args):
        into.append(step)
        return fn(self, step, *args)
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainers3d")
    model_j = JaxTVAE(cfg=JaxTVAEConfig(**TINY))
    g_params = randomize_params(jax.eval_shape(
        model_j.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((1, FRAMES, 16, 16, 3)))["params"], 21)
    pt = str(tmp / "g.pt")
    jax_save_weights_torch(g_params, pt)
    out = {"jax_saves": [], "port_saves": []}

    init = flax_nn.Module.init

    def shaped_init(self, rngs, *args, **kwargs):
        """Zeros of the init's shapes, traced and not compiled: the trainer
        replaces every one of them with the ``load_path`` weights."""
        shapes = jax.eval_shape(lambda: init(self, rngs, *args, **kwargs))
        return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn.Module, "init", shaped_init)
        mp.setattr(jax_trainer3d_mod, "create_mesh",
                   lambda shape: create_mesh(shape, devices=jax.devices()[:1]))
        mp.setattr(jax_trainer3d_mod.Trainer3D, "save",
                   _recording(jax_trainer3d_mod.Trainer3D.save, out["jax_saves"]))
        jt = jax_trainer3d_mod.Trainer3D(
            JaxTrainConfig(**_job(ckpt_dir=str(tmp / "jax"), load_path=pt)),
            JaxTVAEConfig(**TINY), frames=FRAMES)
        jt.train()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer3D, "save", _recording(Trainer3D.save, out["port_saves"]))
        pt_trainer = Trainer3D(TrainConfig(**_job(ckpt_dir=str(tmp / "port"), load_path=pt)),
                               TVAEConfig(**TINY), frames=FRAMES, device="cpu")
        rng = jax.random.PRNGKey(SEED + 1)
        real_step = pt_trainer._step

        def jax_drawn_step(state, clips, draws=None):
            """The port's step fed the JAX step's ε."""
            nonlocal rng
            rng, sub, _ = jax.random.split(rng, 3)
            eps = torch.from_numpy(np.array(jax.random.normal(sub, LATENT), np.float32))
            return real_step(state, clips, Step3DDraws(eps=eps))

        pt_trainer._step = jax_drawn_step
        pt_trainer.train()
    out["port_ckpt_steps"] = pt_trainer.ckpt.steps()
    out["jax"] = _lines(tmp / "jax" / "r" / "metrics_r.jsonl")
    out["port"] = _lines(tmp / "port" / "r" / "metrics_r.jsonl")
    out["pngs"] = {side: sorted(os.listdir(tmp / side / "r" / "eval"))
                   for side in ("jax", "port")}
    return out


def _losses(lines):
    return [ln for ln in lines if "loss" in ln]


def _evals(lines):
    return [ln for ln in lines if "eval/psnr" in ln]


def test_keys_saves_and_frame_strips_are_the_same(runs):
    assert [set(ln) for ln in runs["port"]] == [set(ln) for ln in runs["jax"]]
    assert [ln["step"] for ln in runs["port"]] == [ln["step"] for ln in runs["jax"]]
    assert [ln["step"] for ln in _evals(runs["port"])] == [0, 2, 3]
    assert runs["port_saves"] == runs["jax_saves"] == [1, 3, 3]
    assert runs["port_ckpt_steps"] == [1, 3]
    assert runs["pngs"]["port"] == runs["pngs"]["jax"] == [
        f"reconstructed_clip_frames_step{s}.png" for s in (0, 2, 3)]


@pytest.mark.parametrize("step", range(STEPS))
def test_logged_losses_match_jax(runs, step):
    ref, got = _losses(runs["jax"])[step], _losses(runs["port"])[step]
    assert ref["step"] == got["step"] == step
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=CURVE_RTOL, atol=CURVE_ATOL,
                                   err_msg=f"step {step} {k}")


@pytest.mark.parametrize("i", range(3))
def test_eval_metrics_match_jax(runs, i):
    ref, got = _evals(runs["jax"])[i], _evals(runs["port"])[i]
    assert set(got) == {"step", "eval/recon_l2", "eval/psnr", "eval/ssim"}
    for k in ("eval/recon_l2", "eval/psnr", "eval/ssim"):
        np.testing.assert_allclose(got[k], ref[k], rtol=EVAL_RTOL, err_msg=f"eval {i} {k}")


# ---------------------------------------------------------------------------
# (b) port-only checks

def _trainer(tmp_path, run="p", tvae=None, frames=FRAMES, **kw):
    cfg = TrainConfig(**{**_job(ckpt_dir=str(tmp_path), warmup_steps=1), "run_name": run,
                         **kw})
    return Trainer3D(cfg, TVAEConfig(**{**TINY, **(tvae or {})}), frames=frames,
                     device="cpu")


GAN = dict(do_ganloss=True, disc_type="hinge", use_lecam=True, video_loss_frames=2,
           ema_decay=0.5, learning_rate_disc=1e-3)
# codes unused in a step fall to 0.9 of their count: below 0.95, revived
VQ = dict(reg_type="vq", vq_codebook_size=64, vq_ema_decay=0.9, vq_revive_threshold=0.95)


@pytest.mark.parametrize("kind", ["gan", "vq"])
def test_train_is_the_ports_step(tmp_path, kind):
    """``train()`` for 2 steps equals the same trainer's step driven by hand
    on ``synthetic_video_batches(seed)``: every state tensor, the generator
    and the logged losses. GAN: D moves in step 1, G (lr 0 at step 0) in
    step 2. VQ (EMA, revival at 0.95): the counts move, some codes are
    revived and the rest of the codebook is the fold of the statistics."""
    kw, tvae = (GAN, None) if kind == "gan" else ({}, VQ)
    a = _trainer(tmp_path, "a", tvae, max_steps=2, evaluate_every_n_steps=0, eval_batches=0,
                 **kw)
    a.train()
    b = _trainer(tmp_path, "b", tvae, max_steps=2, evaluate_every_n_steps=0, eval_batches=0,
                 **kw)
    g0 = [p.detach().clone() for p in b.model.parameters()]
    src = synthetic_video_batches(BATCH, FRAMES, 16, seed=SEED)
    logged = []
    for i in range(2):
        d0 = [p.detach().clone() for p in b.disc.parameters()] if b.disc is not None else []
        b.state, m = b._step(b.state, torch.from_numpy(next(src)))
        logged.append({k: float(v) for k, v in m.items()})
        g_moved = any(not torch.equal(p, q) for p, q in zip(b.model.parameters(), g0))
        if kind == "gan":
            assert any(not torch.equal(p, q) for p, q in zip(b.disc.parameters(), d0))
            assert g_moved == (i == 1), f"G moved in step {i + 1}: {g_moved}"
    for x, y in zip(_state_tensors(state_dict_of(a.state)), _state_tensors(state_dict_of(b.state))):
        assert x[0] == y[0] and torch.equal(x[1], y[1]), x[0]
    lines = _losses(_lines(tmp_path / "a" / "metrics_a.jsonl"))
    for ln, ref in zip(lines, logged):
        assert {k: v for k, v in ln.items() if k != "step"} == pytest.approx(ref, rel=1e-6)
    if kind == "vq":
        ema, reg = a.state.vq_ema, a.model.reg
        assert not torch.equal(ema["counts"], torch.ones_like(ema["counts"]))
        revived = ema["counts"] < VQ["vq_revive_threshold"]
        folded = apply_ema_codebook_update(reg.codebook, ema["counts"], ema["sums"],
                                           reg.ema_eps)
        assert 0 < int(revived.sum()) < VQ["vq_codebook_size"]
        assert torch.equal(reg.codebook[~revived], folded[~revived])
        assert not torch.equal(reg.codebook[revived], folded[revived])


@pytest.mark.parametrize("kind", ["gan", "vq"])
def test_load_path_seeds_the_emas(tmp_path, kind):
    """``load_path`` loads G before the train state is built, unlike the JAX
    trainer (which loads into G after it, so its EMAs start from the random
    init): at step 0 G, the Polyak ``g_ema`` (GAN with ``ema_decay``) and
    the VQ EMA sums (EMA-VQ) all equal the loaded weights."""
    kw, tvae = (GAN, None) if kind == "gan" else ({}, VQ)
    cfg = TVAEConfig(**{**TINY, **(tvae or {})})
    src = TVAE(cfg)
    init_weights_(src, torch.Generator().manual_seed(123))
    pt = str(tmp_path / "g.pt")
    save_weights(src, pt)
    loaded = load_weights(pt)
    trainer = _trainer(tmp_path, "l", tvae, load_path=pt, **kw)
    assert trainer.start_step == 0
    params = dict(trainer.model.named_parameters())
    for name, p in params.items():
        assert torch.equal(p.detach(), loaded[name]), name
    if kind == "gan":
        assert set(trainer.state.g_ema) == set(params)
        for name, p in trainer.state.g_ema.items():
            assert torch.equal(p, loaded[name]), name
    else:
        ema = trainer.state.vq_ema
        assert torch.equal(ema["sums"], loaded["reg.codebook"])
        assert torch.equal(ema["counts"], torch.ones_like(ema["counts"]))


def _state_tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _state_tensors(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _state_tensors(v, f"{prefix}.{i}")]
    return []


@pytest.fixture(scope="module")
def gan_job(tmp_path_factory):
    """2 GAN steps with the Polyak EMA, eval and a full state at 1 and 2:
    the trainer, its JSONL lines, its ckpt_dir and the live state."""
    tmp = tmp_path_factory.mktemp("gan_job")
    first = _trainer(tmp, "r", max_steps=2, **GAN)
    first.train()
    return first, _lines(tmp / "r" / "metrics_r.jsonl"), tmp, state_dict_of(first.state)


def test_resume_restores_bitwise_and_reseeds_the_stream(gan_job):
    """``max_steps`` 3 after the 2-step job: the restore is bitwise the state
    the first call ended with (its generator included), and the resumed
    stream's first batch is ``synthetic_video_batches(..., seed=seed + 2)``."""
    _, _, tmp, live = gan_job
    resumed = _trainer(tmp, "r", **GAN)
    assert resumed.start_step == 2 and resumed.ckpt.steps() == [1, 2]
    got = _state_tensors(state_dict_of(resumed.state))
    want = _state_tensors(live)
    assert len(got) == len(want) > 100
    for x, y in zip(got, want):
        assert x[0] == y[0] and x[1].dtype == y[1].dtype and torch.equal(x[1], y[1]), x[0]
    seen = []
    real = resumed._step

    def step(state, clips, draws=None):
        seen.append(clips.clone())
        return real(state, clips, draws)

    resumed._step = step
    resumed.train()
    assert resumed.state.step == 3 and len(seen) == 1
    want_batch = next(synthetic_video_batches(BATCH, FRAMES, 16, seed=SEED + 2))
    assert torch.equal(seen[0], torch.from_numpy(want_batch))


def test_nan_guard_halts_before_a_checkpoint(tmp_path):
    """A non-finite loss in the third step halts the job at the checkpoint
    site right after it (n = 2: after steps 1 and 3) before it saves: the
    last full state stays step 1's."""
    trainer = _trainer(tmp_path, "n")
    real = trainer._step

    def step(state, clips, draws=None):
        state, m = real(state, clips, draws)
        if state.step == 3:
            m = {**m, "loss": torch.tensor(float("nan"))}
        return state, m

    trainer._step = step
    with pytest.raises(DivergenceError, match="non-finite"):
        trainer.train()
    assert trainer.ckpt.steps() == [1]


def test_eval_scores_the_polyak_weights(gan_job):
    """With ``ema_decay`` the eval reconstructs with ``g_ema``: the PSNR the
    2-step job logged at its end is the Polyak weights', not G's."""
    trainer, lines, _, _ = gan_job
    line = _evals(lines)[-1]
    assert line["step"] == 2 and "eval/lpips" in line
    clips = torch.from_numpy(next(synthetic_video_batches(BATCH, FRAMES, 16,
                                                          seed=SEED + EVAL_SEED_OFFSET)))
    target = flat_frames(clips * 0.5 + 0.5)

    def score(params):
        model = trainer.eval_model
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
            recon = model.decode(model.deterministic_latent(model.encode(clips))).float()
        return float(psnr(flat_frames((recon * 0.5 + 0.5).clamp(0, 1)), target))

    ema = score(trainer.state.g_ema)
    raw = score(dict(trainer.model.named_parameters()))
    assert ema != raw
    assert line["eval/psnr"] == pytest.approx(ema, rel=1e-6)


@pytest.mark.parametrize("kw, err, match", [
    # fsdp is ported: in one process it asks for ranks, as data does
    (dict(mesh_shape="data=1,fsdp=2"), ValueError, "torchrun --nproc_per_node"),
    # the context axis is ported for the 3D job: in one process it asks for ranks
    (dict(mesh_shape="data=1,context=2"), ValueError, "torchrun --nproc_per_node"),
    (dict(mesh_shape="data=1,fsdp=2,context=2"), NotImplementedError, "Queue 1: fsdp x context"),
    (dict(mesh_shape="tensor=2,data=-1"), NotImplementedError, "Queue 1: tensor sharding"),
])
def test_unported_options_raise(tmp_path, kw, err, match):
    with pytest.raises(err, match=match):
        _trainer(tmp_path, **kw)


def test_device_is_explicit(tmp_path, monkeypatch):
    """``device`` defaults to "cuda", which raises where torch sees no card
    (there is no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(**_job(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer3D(cfg, TVAEConfig(**TINY), frames=FRAMES)
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer(tmp_path, batch_size=3, grad_accum=2)
