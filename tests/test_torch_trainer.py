"""The port's training job on the CPU at a small size (ch=32, ch_mult 1,2,
32 px): ``Trainer`` end to end (Gaussian latent, GAN, EMA, eval,
checkpoints), exact resume, the NaN guard, the SIGTERM save, the
checkpoint manager, the weight files it reads and writes (the ``.pt`` both
ways with the JAX package, LPIPS and the discriminator's backbone), and the
``train`` CLI's flags against the JAX package's click command.
"""

import dataclasses
import glob
import json
import os
import signal
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqgan_tpu.config import VAEConfig as JaxVAEConfig
from vqgan_tpu.losses.lpips import LPIPS as JaxLPIPS
from vqgan_tpu.models.ae import VAE as JaxVAE
from vqgan_tpu.train.checkpoint import load_weights as jax_load_weights
from vqgan_tpu.train.checkpoint import save_weights_torch as jax_save_weights_torch
from vqgan_tpu_torch import cli
from vqgan_tpu_torch.config import TrainConfig, VAEConfig
from vqgan_tpu_torch.inference import VAEPipeline
from vqgan_tpu_torch.models.ae import VAE
from vqgan_tpu_torch.train.checkpoint import CheckpointManager, state_dict_of
from vqgan_tpu_torch.train.trainer import DivergenceError, Trainer
from vqgan_tpu_torch.utils.logging import write_png
from vqgan_tpu_torch.weights import (
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
    load_weights,
    save_weights,
)

from torch_parity import randomize_params

TINY = dict(resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8,
            enc_dtype="float32", dec_dtype="float32", reg_type="gaussian")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU ops in one thread: beside the other test workers, a
    tiny model's ops spend far longer waiting for threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(tmp_path, run="r", **kw):
    base = dict(synthetic_data=True, batch_size=2, image_size=32, max_steps=3, num_epochs=1,
                evaluate_every_n_steps=0, use_wandb=False, ckpt_dir=str(tmp_path / "ckpt"),
                run_name=run, log_every=1, warmup_steps=1, learning_rate_vae=0.032)
    return TrainConfig(**{**base, **kw})


def _lines(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _state_tensors(tree, prefix=""):
    """Every tensor of a ``state_dict_of`` tree, by path."""
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_state_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_state_tensors(v, f"{prefix}/{i}"))
    return out


def _assert_same_state(a: dict, b: dict):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb)
    for k, v in ta.items():
        assert v.dtype == tb[k].dtype and torch.equal(v, tb[k]), k
    assert a["step"] == b["step"]


def test_trainer_end_to_end_on_the_cpu(tmp_path):
    """Gaussian latent, hinge GAN + LeCam, EMA, flip and crop invariance, an
    image size above the encoder's: losses finite, eval lines with every
    metric and no failure counter, both checkpoint kinds, and the raw .pt
    served by VAEPipeline."""
    cfg = _cfg(tmp_path, max_steps=3, evaluate_every_n_steps=2, image_size=64,
               do_ganloss=True, disc_type="hinge", use_lecam=True, ema_decay=0.5,
               flip_invariance=True, crop_invariance=True, downscale_factor=2, do_clamp=True,
               eval_batches=1)
    trainer = Trainer(cfg, VAEConfig(**TINY), device="cpu")
    assert trainer.device.type == "cpu"
    trainer.train()
    run_dir = tmp_path / "ckpt" / "r"
    lines = _lines(run_dir / "metrics_r.jsonl")
    assert "_config" in lines[0] and lines[0]["_config"]["reg_type"] == "gaussian"
    steps = [ln for ln in lines if "overall_vae_loss" in ln]
    assert [ln["step"] for ln in steps] == [0, 1, 2]
    assert all(np.isfinite(v) for ln in steps for v in ln.values())
    evals = [ln for ln in lines if any(k.startswith("eval/") for k in ln)]
    assert [ln["step"] for ln in evals] == [1, 3]
    for ln in evals:
        assert set(ln) == {"step", "eval/lpips", "eval/rfid_vgg_proxy", "eval/psnr",
                           "eval/ssim"}
        assert -1.0 <= ln["eval/ssim"] <= 1.0
    assert glob.glob(str(run_dir / "eval" / "reconstructed_test_images_step*.png"))
    for name in ("vae_epoch_0_step_1.pt", "vae_epoch_0_step_1_ema.pt",
                 "vae_epoch_final_step_3.pt", "vae_epoch_final_step_3_ema.pt"):
        assert (run_dir / name).exists(), name
    assert trainer.ckpt.steps() == [1, 3]
    pipe = VAEPipeline.from_checkpoint(str(run_dir / "vae_epoch_final_step_3.pt"),
                                       VAEConfig(**TINY), device="cpu")
    recon = pipe.reconstruct(np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3), np.uint8))
    assert recon.shape == (2, 32, 32, 3) and np.isfinite(recon).all()
    assert recon.min() >= 0.0 and recon.max() <= 1.0
    ema = load_weights(str(run_dir / "vae_epoch_final_step_3_ema.pt"))
    assert all(torch.equal(v, trainer.state.g_ema[k]) for k, v in ema.items())


@pytest.fixture(scope="module")
def png_shard(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(1)
    path = str(root / "00000.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(10):
            png = str(root / f"{i}.png")
            write_png(png, rng.randint(0, 256, (40, 48, 3)).astype(np.uint8))
            tf.add(png, arcname=f"{i:03d}.png")
    return path


def test_resume_is_bitwise(tmp_path, png_shard):
    """Indexed data (sample-exact resume): 4 straight steps equal 2 steps,
    a resume, and 2 more, bit for bit — G, D, both AdamW states, the
    schedule, LeCam, the EMA, the generator. Right after the restore every
    tensor of the state is bitwise the one the first run ended with (and
    saved). Crop invariance is off: its coin restarts from the seed on a
    resume, in JAX's order (test_crop_coin_restarts_on_resume)."""
    kw = dict(synthetic_data=False, dataset_url=png_shard, num_workers=1, do_ganloss=True,
              disc_type="hinge", use_lecam=True, ema_decay=0.5, flip_invariance=True,
              augment_before_perceptual_loss=True)
    vae_cfg = VAEConfig(**TINY)
    straight = Trainer(_cfg(tmp_path, "a", max_steps=4, **kw), vae_cfg, device="cpu")
    straight.train()
    first = Trainer(_cfg(tmp_path, "b", max_steps=2, **kw), vae_cfg, device="cpu")
    first.train()
    live = state_dict_of(first.state)
    resumed = Trainer(_cfg(tmp_path, "b", max_steps=4, **kw), vae_cfg, device="cpu")
    assert resumed.state.step == 2
    _assert_same_state(state_dict_of(resumed.state), live)
    _assert_same_state(live, resumed.ckpt.read(2))
    resumed.train()
    _assert_same_state(state_dict_of(resumed.state), state_dict_of(straight.state))
    losses = [[ln["overall_vae_loss"] for ln in _lines(tmp_path / "ckpt" / r / f"metrics_{r}.jsonl")
               if "overall_vae_loss" in ln] for r in ("a", "b")]
    assert losses[0] == losses[1]


def test_crop_coin_restarts_on_resume(tmp_path):
    """The crop coin is ``np.random.default_rng(seed)``, made anew by each
    Trainer, as the JAX trainer's is (trainer.py:198, 337-340): a resumed
    run draws the buckets that the run's first steps drew, so with crop
    invariance a resume is not bitwise the straight run."""
    def buckets(trainer):
        drawn, real = [], trainer._step
        trainer._step = lambda state, batch, do_crop=0: (drawn.append(do_crop)
                                                         or real(state, batch, do_crop))
        trainer.train()
        return drawn

    kw = dict(crop_invariance=True, downscale_factor=2, seed=3)
    first = buckets(Trainer(_cfg(tmp_path, max_steps=2, **kw), VAEConfig(**TINY), device="cpu"))
    resumed = Trainer(_cfg(tmp_path, max_steps=4, **kw), VAEConfig(**TINY), device="cpu")
    assert resumed.state.step == 2
    assert buckets(resumed) == first
    rng = np.random.default_rng(3)
    assert first == [1 + int(rng.integers(3)) if rng.random() < 0.5 else 0 for _ in range(2)]
    assert any(first)


def test_resume_reseeds_the_synthetic_stream(tmp_path):
    """Without a sample-exact cursor the train stream's seed folds in the
    resume step; the eval stream keeps its seed (JAX trainer.py:213-224)."""
    cfg = _cfg(tmp_path, max_steps=1)
    t1 = Trainer(cfg, VAEConfig(**TINY), device="cpu")
    fresh = next(t1._make_loader(True))
    t1.train()
    t2 = Trainer(cfg, VAEConfig(**TINY), device="cpu")
    assert t2.state.step == 1
    assert not np.allclose(fresh, next(t2._make_loader(True)))
    np.testing.assert_array_equal(next(t1._make_loader(False)), next(t2._make_loader(False)))


@pytest.mark.parametrize("site", ["log", "final_save"])
def test_nan_guard_halts_without_a_checkpoint(tmp_path, site):
    """A non-finite loss halts training before the next checkpoint: caught
    at the log site, or, off the log cadence, by the final save's guard."""
    if site == "log":
        cfg = _cfg(tmp_path, max_steps=50, evaluate_every_n_steps=3, log_every=1)
    else:
        cfg = _cfg(tmp_path, max_steps=2, log_every=1000)
    trainer = Trainer(cfg, VAEConfig(**TINY), device="cpu")
    real_step = trainer._step

    def poisoned(state, batch, do_crop=0, draws=None):
        state, metrics = real_step(state, batch, do_crop, draws)
        if site == "final_save" or state.step >= 2:
            metrics = {**metrics, "overall_vae_loss": torch.tensor(float("nan"))}
        return state, metrics

    trainer._step = poisoned
    with pytest.raises(DivergenceError):
        trainer.train()
    latest = trainer.ckpt.latest_step()
    assert latest is None or latest < 2, latest
    assert not glob.glob(str(tmp_path / "ckpt" / "r" / "vae_epoch_*_step_2.pt"))


def test_sigterm_saves_the_full_state(tmp_path):
    """A SIGTERM during a step checkpoints the full state at the next step
    boundary and returns."""
    trainer = Trainer(_cfg(tmp_path, max_steps=100), VAEConfig(**TINY), device="cpu")
    real_step = trainer._step

    def step_then_signal(state, batch, do_crop=0, draws=None):
        out = real_step(state, batch, do_crop, draws)
        if out[0].step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer._step = step_then_signal
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        trainer.train()
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    assert trainer.state.step == 2 and trainer.ckpt.latest_step() == 2
    _assert_same_state(state_dict_of(trainer.state), trainer.ckpt.read())
    assert (tmp_path / "ckpt" / "r" / "vae_epoch_0_step_2.pt").exists()


def test_checkpoint_manager(tmp_path, monkeypatch):
    """The newest ``max_to_keep`` kept, no temporary file left, each file
    read with ``weights_only=True``; a state of another configuration is
    refused; a failed background write raises at the next wait."""
    trainer = Trainer(_cfg(tmp_path, ema_decay=0.9), VAEConfig(**TINY), device="cpu")
    mngr = CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    assert mngr.latest_step() is None and mngr.restore(trainer.state) is None
    for s in (3, 1, 7):
        mngr.save(s, state_dict_of(trainer.state))
    assert mngr.steps() == [3, 7] and mngr.latest_step() == 7
    assert sorted(os.listdir(mngr.directory)) == ["step_00000003.pt", "step_00000007.pt"]
    saved = torch.load(mngr.path(7), map_location="cpu", weights_only=True)
    _assert_same_state(saved, state_dict_of(trainer.state))
    other = Trainer(_cfg(tmp_path, "o"), VAEConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="g_ema"):
        mngr.restore(other.state)

    def full_disk(obj, f):
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", full_disk)
    mngr.save(8, state_dict_of(trainer.state))
    with pytest.raises(OSError, match="no space"):
        mngr.wait()
    assert mngr.steps() == [3, 7]


def test_checkpoint_manager_writes_reference_weights(tmp_path):
    """``save``'s ``weights``: reference-format .pt files from the same host
    copy, on the background thread: G's weights as ``save_weights`` of the
    model writes them, the Polyak average as the state holds it."""
    trainer = Trainer(_cfg(tmp_path, ema_decay=0.9), VAEConfig(**TINY), device="cpu")
    mngr = CheckpointManager(str(tmp_path / "m"))
    raw, ema, direct = (str(tmp_path / n) for n in ("raw.pt", "ema.pt", "direct.pt"))
    mngr.save(4, state_dict_of(trainer.state), {raw: "g_model", ema: "g_ema"})
    mngr.wait()
    save_weights(trainer.vae, direct)
    for written, want in ((load_weights(raw), load_weights(direct)),
                          (load_weights(ema), trainer.state.g_ema)):
        assert set(written) == set(want)
        assert all(v.dtype == torch.float32 and torch.equal(v, want[k])
                   for k, v in written.items())
    assert mngr.steps() == [4]


def test_trainer_device_is_explicit(tmp_path):
    """The default device is the card; without one the trainer and the CLI
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert Trainer(_cfg(tmp_path), VAEConfig(**TINY)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg(tmp_path), VAEConfig(**TINY))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--synthetic_data", "true", "--ckpt_dir", str(tmp_path)])


@pytest.mark.parametrize("kw,err,what", [
    (dict(crop_invariance=True, downscale_factor=16), ValueError, "downscale_factor"),
    # fsdp is ported: in one process it asks for ranks, as data does
    (dict(mesh_shape="data=1,fsdp=2"), ValueError, "mesh_shape.*torchrun"),
    (dict(grad_accum=3), ValueError, "grad_accum"),
    # one process without torch.distributed is one rank
    (dict(mesh_shape="data=2"), ValueError, "torchrun --nproc_per_node"),
    (dict(mesh_shape="data=1,tensor=2"), NotImplementedError, "Queue 1: tensor sharding"),
    # the context axis is ported for both jobs: it asks for ranks too
    (dict(mesh_shape="data=1,context=2"), ValueError, "torchrun --nproc_per_node"),
    (dict(mesh_shape="data=1,fsdp=2,context=2"), NotImplementedError, "Queue 1: fsdp x context"),
])
def test_trainer_validates_its_config(tmp_path, kw, err, what):
    with pytest.raises(err, match=what):
        Trainer(_cfg(tmp_path, **kw), VAEConfig(**TINY), device="cpu")


@pytest.fixture(scope="module")
def jax_vae():
    cfg = JaxVAEConfig(**TINY)
    vae_j = JaxVAE(cfg=cfg)
    shapes = jax.eval_shape(vae_j.init, {"params": jax.random.PRNGKey(0),
                                         "sample": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 32, 32, 3)))["params"]
    return vae_j, randomize_params(shapes, 3)


def test_weights_pt_both_ways_with_jax(tmp_path, jax_vae):
    """JAX's ``save_weights_torch`` → the port's ``load_weights`` gives the
    same VAE output; the port's ``save_weights`` → JAX ``load_weights``
    gives the same tree."""
    vae_j, params = jax_vae
    path = str(tmp_path / "jax.pt")
    jax_save_weights_torch(params, path)
    vae = VAE(VAEConfig(**TINY))
    vae.load_state_dict(load_weights(path), strict=True)
    x = np.random.RandomState(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    eps = np.random.RandomState(5).randn(2, 16, 16, 8).astype(np.float32)
    z_j = vae_j.apply({"params": params}, jnp.asarray(x), method=vae_j.encode)
    mean, logvar = jnp.split(z_j, 2, axis=-1)
    ref = vae_j.apply({"params": params},
                      mean + jnp.exp(0.5 * jnp.clip(logvar, -3.0)) * jnp.asarray(eps),
                      method=vae_j.decode)
    with torch.no_grad():
        got, _ = vae(torch.from_numpy(x), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    back = str(tmp_path / "port.pt")
    save_weights(vae, back)
    tree = jax_load_weights(back)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    sd = jax_params_to_state_dict(tree)
    assert set(sd) == set(vae.state_dict())
    for k, v in vae.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_lpips_weight_files_match_jax(tmp_path):
    """An ``--lpips_weights`` .npz (flat ``a/b/c`` keys) and the reference's
    ``vgg.pth`` load into the port's LPIPS as the JAX loader reads them; a
    ``--disc_backbone_weights`` file sets D's VGG and leaves its heads."""
    x0 = jnp.zeros((1, 32, 32, 3))
    params = randomize_params(jax.eval_shape(JaxLPIPS().init, jax.random.PRNGKey(0), x0,
                                             x0)["params"], 6)
    flat = {f"vgg/{c}/{leaf}": v for c, conv in params["vgg"].items() for leaf, v in conv.items()}
    flat.update({f"lin_{k}": params[f"lin_{k}"] for k in range(5)})
    npz = str(tmp_path / "lpips.npz")
    np.savez(npz, **flat)
    # every key is in the file, so the JAX loader's merge gives ``params``
    ref = jax_lpips_params_to_state_dict(params)
    pth = str(tmp_path / "vgg.pth")
    torch.save(ref, pth)
    for path in (npz, pth):
        trainer = Trainer(_cfg(tmp_path, os.path.basename(path), lpips_weights=path,
                               do_ganloss=True, disc_backbone_weights=npz),
                          VAEConfig(**TINY), device="cpu")
        got = trainer.lpips.state_dict()
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref), path
        d = trainer.disc.state_dict()
        for k, v in ref.items():
            if k.startswith("net."):
                n, idx, leaf = k.split(".")[1:]
                assert torch.equal(d[f"{n}.0.{idx}.{leaf}"], v), k


def _click_params():
    from vqgan_tpu.cli import train

    return {p.name: p for p in train.params}


def test_cli_flags_and_defaults_match_jax():
    """Every flag of ``vqgan_tpu.cli train`` by the same name, default and
    kind (a switch, or a value), and only ``--device`` beside them."""
    ours = {a.dest: a for a in cli.build_parser()._actions if a.dest != "help"}
    theirs = _click_params()
    assert set(ours) == set(theirs) | {"device"}
    for name, p in theirs.items():
        a = ours[name]
        assert a.default == p.default, name
        assert (a.nargs == 0) == p.is_flag, name
    assert ours["device"].default == "cuda"


@pytest.mark.parametrize("argv", [
    [],
    ["--do_ganloss", "--do_clamp", "--vae_ch", "64", "--vae_ch_mult", "1,2,4",
     "--reg_type", "vq", "--do_attn", "TRUE", "--synthetic_data", "yes", "--full_bf16", "1",
     "--use_lecam", "on", "--disc_type", "hinge", "--indexed_data", "false",
     "--load_path", "w.pt", "--ema_decay", "0.999", "--mesh_shape", "data=1",
     "--image_size", "384", "--use_wandb", "f", "--profile_dir", "p"],
])
def test_cli_builds_the_jax_configs(argv, monkeypatch):
    """The same flags give the same TrainConfig and VAEConfig fields as the
    JAX CLI builds (its Trainer replaced by a recorder)."""
    import vqgan_tpu.train.trainer as jax_trainer
    from vqgan_tpu.cli import train

    seen = {}

    class Recorder:
        def __init__(self, cfg, vae_cfg):
            seen.update(cfg=cfg, vae_cfg=vae_cfg)

        def train(self):
            pass

    monkeypatch.setattr(jax_trainer, "Trainer", Recorder)
    train.main(argv, standalone_mode=False)
    cfg, vae_cfg = cli.configs(vars(cli.build_parser().parse_args(argv)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"])
    assert dataclasses.asdict(vae_cfg) == dataclasses.asdict(seen["vae_cfg"])


def test_profile_dir_traces_steps_10_to_15(tmp_path):
    """``--profile_dir``: a torch.profiler chrome trace from step 10 (to 15,
    or to the end of a shorter run)."""
    cfg = _cfg(tmp_path, max_steps=12, batch_size=1, log_every=100,
               profile_dir=str(tmp_path / "prof"))
    trainer = Trainer(cfg, VAEConfig(**{**TINY, "reg_type": "identity_gaussian"}), device="cpu")
    trainer.train()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    convs = sum(e.get("name") == "aten::convolution" for e in events)
    assert convs >= 2 * 28, convs  # the forward of the VAE's 28 convs in steps 10 and 11


def test_cli_runs_a_job_and_refuses_train3d(tmp_path):
    """``train`` and ``train3d`` each run a tiny job on the CPU through
    ``cli.main``; ``train3d`` refuses what the port does not train yet, a
    mesh of several devices, naming its ROADMAP.md item."""
    argv = ["train", "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "8", "--vae_resolution", "32",
            "--batch_size", "2", "--image_size", "32", "--synthetic_data", "true",
            "--reg_type", "gaussian", "--max_steps", "2", "--evaluate_every_n_steps", "0",
            "--use_wandb", "false", "--ckpt_dir", str(tmp_path), "--log_every", "1"]
    trainer = cli.main(argv)
    assert trainer.state.step == 2 and trainer.ckpt.latest_step() == 2
    assert trainer.vae_cfg.reg_type == "gaussian" and trainer.cfg.max_steps == 2
    argv3d = ["train3d", "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
              "--vae_num_res_blocks", "1", "--vae_z_channels", "4", "--vae_resolution", "16",
              "--frames", "4", "--batch_size", "2", "--max_steps", "2",
              "--evaluate_every_n_steps", "0", "--use_wandb", "false",
              "--ckpt_dir", str(tmp_path), "--log_every", "1"]
    trainer3d = cli.main(argv3d)
    assert trainer3d.state.step == 2 and trainer3d.ckpt.steps() == [2]
    assert trainer3d.frames == 4 and trainer3d.cfg.synthetic_data and not trainer3d.use_gan
    lines = _lines(tmp_path / "tvae_run" / "metrics_tvae_run.jsonl")
    assert [ln["step"] for ln in lines] == [0, 1, 2]  # the final eval at max_steps
    assert set(lines[2]) == {"step", "eval/recon_l2", "eval/psnr", "eval/ssim"}
    # the 3D job takes the context axis: one process is one rank
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(argv3d + ["--mesh_shape", "data=1,context=2"])
    with pytest.raises(NotImplementedError, match="Queue 1: fsdp x context"):
        cli.main(argv3d + ["--mesh_shape", "data=1,fsdp=2,context=2"])
    with pytest.raises(ValueError, match="torchrun"):
        cli.main(argv3d + ["--mesh_shape", "data=2"])
    with pytest.raises(SystemExit):
        cli.main(["--do_attn", "maybe"])


def _click_params_3d():
    from vqgan_tpu.cli import train3d

    return {p.name: p for p in train3d.params}


def test_train3d_flags_and_defaults_match_jax():
    """Every flag of ``vqgan_tpu.cli train3d`` by the same name, default and
    kind (every one takes a value, ``--do_ganloss true`` too), and only
    ``--device`` beside them."""
    ours = {a.dest: a for a in cli.build_parser_3d()._actions if a.dest != "help"}
    theirs = _click_params_3d()
    assert set(ours) == set(theirs) | {"device"}
    for name, p in theirs.items():
        a = ours[name]
        assert a.default == p.default, name
        assert a.nargs != 0 and not p.is_flag, name
    assert ours["device"].default == "cuda"
    assert cli.build_parser_3d().parse_args(["--do_ganloss", "true"]).do_ganloss is True


@pytest.mark.parametrize("argv", [
    [],
    ["--do_ganloss", "true", "--vae_ch", "32", "--vae_ch_mult", "1,2,4", "--reg_type", "vq",
     "--vq_ema_decay", "0.9", "--conv3d_impl", "pallas", "--attn_chunk", "256",
     "--disc_3d", "tubelet", "--video_loss_frames", "4", "--use_lecam", "on",
     "--disc_type", "hinge", "--ema_decay", "0.999", "--dataset_url", "clips.tar",
     "--load_path", "w.pt", "--frames", "16", "--fused_gn_swish", "1", "--use_wandb", "f"],
])
def test_train3d_builds_the_jax_configs(argv, monkeypatch):
    """The same ``train3d`` flags give the same TrainConfig and TVAEConfig
    fields and frame count as the JAX CLI builds (its Trainer3D replaced by
    a recorder)."""
    import vqgan_tpu.train.trainer3d as jax_trainer3d
    from vqgan_tpu.cli import train3d

    seen = {}

    class Recorder:
        def __init__(self, cfg, tvae_cfg, frames):
            seen.update(cfg=cfg, tvae_cfg=tvae_cfg, frames=frames)

        def train(self):
            pass

    monkeypatch.setattr(jax_trainer3d, "Trainer3D", Recorder)
    train3d.main(argv, standalone_mode=False)
    kw = vars(cli.build_parser_3d().parse_args(argv))
    cfg, tvae_cfg = cli.configs_3d(kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(seen["cfg"])
    assert dataclasses.asdict(tvae_cfg) == dataclasses.asdict(seen["tvae_cfg"])
    assert kw["frames"] == seen["frames"]
