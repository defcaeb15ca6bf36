"""``MetricLogger``'s wandb start on the CPU: a failed ``wandb.init`` must not
pin the trainer that built the logger.

wandb's error reporter keeps the exception of a failed init, and a traceback
reaches every frame above the raise through ``f_back``; from a trainer's
``__init__`` that is the trainer, its model and its optimizer states. The
stand-in ``wandb`` below keeps the exception the same way, so a trainer
dropped after a failed init must be collected all the same.
"""

import gc
import sys
import types
import weakref

import pytest
import torch

from vqgan_tpu_torch.config import TrainConfig, TVAEConfig, VAEConfig
from vqgan_tpu_torch.train.trainer import Trainer
from vqgan_tpu_torch.train.trainer3d import Trainer3D
from vqgan_tpu_torch.utils.logging import MetricLogger


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stand_in(monkeypatch, fail: bool):
    """A ``wandb`` module: ``init`` raises and keeps what it raised where
    ``fail``, else records its arguments; ``log`` records its calls."""
    mod = types.ModuleType("wandb")
    mod.kept, mod.inits, mod.logged = [], [], []

    def init(**kw):
        if fail:
            try:
                raise RuntimeError("wandb.init: not logged in")
            except RuntimeError as e:
                mod.kept.append(e)  # as the error reporter keeps it, traceback and all
                raise
        mod.inits.append(kw)

    mod.init = init
    mod.log = lambda metrics, step: mod.logged.append((step, metrics))
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def _train_cfg(tmp_path):
    return TrainConfig(synthetic_data=True, batch_size=2, image_size=32, max_steps=1,
                       num_epochs=1, evaluate_every_n_steps=0, use_wandb=True,
                       ckpt_dir=str(tmp_path / "ckpt"), run_name="r")


@pytest.mark.parametrize("family", ["2d", "3d"])
def test_failed_wandb_init_does_not_pin_the_trainer(tmp_path, monkeypatch, family):
    wandb = _stand_in(monkeypatch, fail=True)
    if family == "2d":
        trainer = Trainer(_train_cfg(tmp_path), VAEConfig(
            resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=8),
            device="cpu")
    else:
        trainer = Trainer3D(_train_cfg(tmp_path), TVAEConfig(
            resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4),
            frames=4, device="cpu")
    assert len(wandb.kept) == 1 and trainer.logger.wandb is None
    model = weakref.ref(trainer.state.g_model)
    trainer.logger.close()
    del trainer
    gc.collect()
    assert model() is None, "the kept wandb exception pins the dropped trainer's model"


def test_wandb_logging_when_init_works(tmp_path, monkeypatch):
    """A working wandb gets the init's arguments and every logged line, as
    before."""
    wandb = _stand_in(monkeypatch, fail=False)
    logger = MetricLogger("run", "proj", config={"a": 1}, out_dir=str(tmp_path))
    assert logger.wandb is wandb
    assert wandb.inits == [dict(project="proj", name="run", config={"a": 1})]
    logger.log({"loss": 0.5, "bad": float("nan"), "text": "x"}, step=3)
    logger.close()
    assert wandb.logged == [(3, {"loss": 0.5})]
