"""The training jobs with accumulation and rematerialization through
``vqgan_tpu_torch.cli.main``, on the CPU, and the HDR recipe's flag list.

- ``train`` with the HDR recipe's model options (``--use_wavelet true
  --decoder_also_perform_hr true``) and ``--grad_accum 2 --remat true`` at a
  tiny width, on an indexed PNG shard (a sample-exact resume) with 24 px
  images for a 16 px encoder and a 32 px HR target, batch 2 in microbatches
  of 1: 3 straight steps equal 2 steps, a save, a resume and 1 more, bit for
  bit; right after the restore the state is bitwise the one the first call
  ended with.
- ``train3d --grad_accum 2 --remat true`` with the GAN loss: 2 steps, the
  saves, a resume to 3 that restores the live state bitwise.
- ``chip_smoke.TRAIN_HDR_JOB`` is ``tools/launch_hdr.sh``'s flag list, as its
  ``python -m vqgan_tpu.cli`` line gives it with the empty defaults of its
  variables, plus the named overrides, so flag drift between the recipe and
  the card's run fails here.
"""

import json
import os
import re
import shlex
import tarfile

import numpy as np
import pytest
import torch

import chip_smoke
from vqgan_tpu_torch import cli
from vqgan_tpu_torch.train import trainer as trainer_mod
from vqgan_tpu_torch.train import trainer3d as trainer3d_mod
from vqgan_tpu_torch.train.checkpoint import state_dict_of
from vqgan_tpu_torch.utils.logging import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_2D = ["--vae_ch", "32", "--vae_ch_mult", "1,2", "--vae_num_res_blocks", "1",
           "--vae_z_channels", "8", "--vae_resolution", "16", "--downscale_factor", "2"]
HDR_OPTIONS = ["--use_wavelet", "true", "--decoder_also_perform_hr", "true",
               "--do_ganloss", "--disc_type", "hinge", "--use_lecam", "true",
               "--do_clamp", "--clamp_th", "8.0", "--flip_invariance", "true"]
ACCUM_REMAT = ["--grad_accum", "2", "--remat", "true"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state_tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_state_tensors(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_state_tensors(v, f"{prefix}/{i}"))
    return out


def _assert_same_state(a: dict, b: dict):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb) and len(ta) > 100
    for k, v in ta.items():
        assert v.dtype == tb[k].dtype and torch.equal(v, tb[k]), k
    assert a["step"] == b["step"]


def _losses(path, key):
    return [json.loads(line)[key] for line in open(path)
            if line.strip() and key in json.loads(line)]


@pytest.fixture(scope="module")
def png_shard(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(1)
    path = str(root / "00000.tar")
    with tarfile.open(path, "w") as tf:
        for i in range(12):
            png = str(root / f"{i}.png")
            write_png(png, rng.randint(0, 256, (28, 30, 3)).astype(np.uint8))
            tf.add(png, arcname=f"{i:03d}.png")
    return path


def test_hdr_options_with_accum_and_remat_resume_bitwise(tmp_path, png_shard, monkeypatch):
    base = (["train", "--device", "cpu"] + TINY_2D + HDR_OPTIONS + ACCUM_REMAT
            + ["--dataset_url", png_shard, "--num_workers", "1", "--batch_size", "2",
               "--image_size", "24", "--evaluate_every_n_steps", "0", "--use_wandb", "false",
               "--log_every", "1", "--learning_rate_vae", "0.032",
               "--ckpt_dir", str(tmp_path)])
    straight = cli.main(base + ["--run_name", "a", "--max_steps", "3"])
    assert straight.cfg.grad_accum == 2 and straight.vae_cfg.remat
    assert straight.vae_cfg.use_wavelet and straight.vae_cfg.decoder_also_perform_hr
    first = cli.main(base + ["--run_name", "b", "--max_steps", "2"])
    live = state_dict_of(first.state)
    assert first.ckpt.latest_step() == 2
    _assert_same_state(live, first.ckpt.read(2))

    restored = []
    real_train = trainer_mod.Trainer.train

    def train(self):
        restored.append(state_dict_of(self.state))
        real_train(self)

    monkeypatch.setattr(trainer_mod.Trainer, "train", train)
    resumed = cli.main(base + ["--run_name", "b", "--max_steps", "3"])
    assert restored[0]["step"] == 2
    _assert_same_state(restored[0], live)
    _assert_same_state(state_dict_of(resumed.state), state_dict_of(straight.state))
    losses = [_losses(tmp_path / r / f"metrics_{r}.jsonl", "overall_vae_loss") for r in "ab"]
    assert len(losses[0]) == 3 and losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))


def test_train3d_with_accum_and_remat_resumes_bitwise(tmp_path, monkeypatch):
    base = ["train3d", "--device", "cpu", "--vae_ch", "32", "--vae_ch_mult", "1,2",
            "--vae_num_res_blocks", "1", "--vae_z_channels", "4", "--vae_resolution", "16",
            "--frames", "4", "--batch_size", "2", "--do_ganloss", "true", "--disc_type",
            "hinge", "--use_lecam", "true", "--video_loss_frames", "2", "--ema_decay", "0.5",
            "--evaluate_every_n_steps", "2", "--eval_batches", "1", "--use_wandb", "false",
            "--log_every", "1", "--ckpt_dir", str(tmp_path)] + ACCUM_REMAT
    first = cli.main(base + ["--max_steps", "2"])
    assert first.cfg.grad_accum == 2 and first.tvae_cfg.remat and first.use_gan
    assert first.state.step == 2 and first.ckpt.steps() == [1, 2]
    live = state_dict_of(first.state)
    restored = []
    real_train = trainer3d_mod.Trainer3D.train

    def train(self):
        restored.append(state_dict_of(self.state))
        real_train(self)

    monkeypatch.setattr(trainer3d_mod.Trainer3D, "train", train)
    resumed = cli.main(base + ["--max_steps", "3"])
    assert restored[0]["step"] == 2
    _assert_same_state(restored[0], live)
    assert resumed.state.step == 3
    losses = _losses(tmp_path / "tvae_run" / "metrics_tvae_run.jsonl", "loss")
    assert len(losses) == 3 and all(np.isfinite(losses))


def _script_flags(path):
    """The flags of the script's ``python -m vqgan_tpu.cli`` command: line
    continuations joined, ``$(python -c 'print(2**-7)')`` evaluated, each
    ``${VAR}`` its default, empty."""
    text = open(path).read().replace("\\\n", " ")
    (line,) = [ln for ln in text.splitlines() if "python -m vqgan_tpu.cli" in ln]
    line = line.replace("\"$(python -c 'print(2**-7)')\"", repr(str(2 ** -7)))
    line = re.sub(r"\$\{[A-Z_]+\}", "", line)
    words = shlex.split(line)
    return words[words.index("vqgan_tpu.cli") + 1:]


def test_train_hdr_job_is_the_recipe_plus_named_overrides():
    flags = _script_flags(os.path.join(REPO, "tools", "launch_hdr.sh"))
    assert "--use_wavelet" in flags and flags[flags.index("--batch_size") + 1] == "32"
    assert flags[flags.index("--learning_rate_vae") + 1] == "0.0078125"
    job = chip_smoke.TRAIN_HDR_JOB
    assert job[:len(flags)] == flags
    assert job[len(flags):] == chip_smoke.HDR_OVERRIDES
    assert chip_smoke.HDR_OVERRIDES == [
        "--synthetic_data", "true", "--grad_accum", "4", "--max_steps", "4",
        "--evaluate_every_n_steps", "2", "--eval_batches", "1", "--log_every", "1",
        "--use_wandb", "false"]
    # the port's CLI takes the whole line; argparse keeps the last of a flag
    kw = vars(cli.build_parser().parse_args(job + ["--ckpt_dir", "x"]))
    cfg, vae_cfg = cli.configs(kw)
    assert (cfg.batch_size, cfg.grad_accum, cfg.max_steps, cfg.image_size) == (32, 4, 4, 512)
    assert (vae_cfg.ch, vae_cfg.ch_mult, vae_cfg.z_channels) == (128, (1, 2, 4, 4, 4), 64)
    assert vae_cfg.use_wavelet and vae_cfg.decoder_also_perform_hr
    assert vae_cfg.decoder_ch_mult == (2, 2, 4, 4, 4, 4)
    assert cfg.do_ganloss and cfg.use_lecam and cfg.do_clamp and cfg.crop_invariance
