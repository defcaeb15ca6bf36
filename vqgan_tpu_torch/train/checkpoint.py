"""Checkpoints: the full train state, and reference-format weights
(counterpart of ``vqgan_tpu/train/checkpoint.py``).

The reference saves weights-only state dicts on eval cadence and resumes
with ``--load_path`` (vae_trainer.py:505-513, 903-910), losing the optimizer
state on every restart. ``CheckpointManager`` saves the whole
``TrainState`` instead — G and D params, both AdamW states, G's scheduler,
the LeCam anchors, the Polyak average, the VQ EMA statistics, the step and
the state's generator — so a resumed run continues exactly. The JAX package
writes Orbax directories; the port writes one ``torch.save`` file a step,
``step_{n:08d}.pt``, of plain tensors and numbers that ``torch.load`` reads
with ``weights_only=True``. A save copies the state to the host, then writes
the file on a background thread while training goes on (as the JAX
package's async Orbax saves do; ``wait()`` joins it); the file goes to a
temporary name first and is renamed into place, so a crash never leaves a
torn checkpoint under the final name.

The reference-format ``.pt`` for interop, the JAX package's
``save_weights_torch`` / ``load_weights``, is ``weights.py``'s
``save_weights`` / ``load_weights``; a save can write such files from the
same host copy, on the same thread (the JAX package writes them before
its async save, on the loop's thread).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch

from vqgan_tpu_torch.train.state import TrainState
from vqgan_tpu_torch.weights import save_weights

_NAME = re.compile(r"step_(\d+)\.pt")


def _cpu(tree: Any) -> Any:
    """Every tensor of a state-dict tree as a CPU copy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def state_tree(state: TrainState) -> dict:
    """The train state as a tree of its live tensors and plain numbers: of
    this rank's blocks where the state is sharded over fsdp."""
    return {
        "step": int(state.step),
        "g_model": state.g_model.state_dict(),
        "g_opt": state.g_opt.state_dict(),
        "g_sched": state.g_sched.state_dict() if state.g_sched is not None else None,
        "d_model": state.d_model.state_dict() if state.d_model is not None else None,
        "d_opt": state.d_opt.state_dict() if state.d_opt is not None else None,
        "lecam_real": state.lecam_real,
        "lecam_fake": state.lecam_fake,
        "generator": state.generator.get_state(),
        "g_ema": state.g_ema,
        "vq_ema": state.vq_ema,
    }


def state_dict_of(state: TrainState, keep: bool = True) -> Optional[dict]:
    """The full train state as a tree of CPU tensors and plain numbers.
    Sharded over fsdp the tree is gathered whole, the same tree as an
    unsharded state's: every rank of the fsdp group must call it, and a
    rank that passes ``keep=False`` (one that writes nothing) takes part in
    the gathers and gets None."""
    tree = state.layout.gather_tree(state, state_tree(state), keep=keep)
    return None if tree is None else _cpu(tree)


def _same_parts(state: TrainState, saved: dict) -> None:
    for key in ("g_sched", "d_model", "d_opt", "g_ema", "vq_ema"):
        if (saved[key] is None) != (getattr(state, key) is None):
            raise ValueError(f"checkpoint {key} is {'absent' if saved[key] is None else 'present'}"
                             f", the train state's is not: another configuration")


def _load_optimizer(opt: torch.optim.Optimizer, saved: dict) -> None:
    """The saved per-parameter state (AdamW's moments and step count) into
    ``opt``; its hyperparameters stay this run's, as optax keeps only counts
    and moments in its state and takes the rest from the current config."""
    current = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
    opt.load_state_dict(saved)
    for group, hyper in zip(opt.param_groups, current):
        group.update(hyper)


@torch.no_grad()
def load_state_into(state: TrainState, saved: dict) -> TrainState:
    """Restore ``state`` in place from ``state_dict_of``'s tree: the models
    load their state dicts, the optimizers their per-parameter state, every
    other tensor is copied into the state's own (on its device), the
    generator takes its state. G's schedule resumes at the saved step with
    this run's lambda (a resumed run may have another ``max_steps``, and the
    JAX schedule is a function of the step and the current config).
    Sharded over fsdp, the state takes this rank's blocks of the whole
    tree, so a checkpoint of any layout loads."""
    _same_parts(state, saved)
    saved = state.layout.shard_tree(state, saved)
    state.g_model.load_state_dict(saved["g_model"], strict=True)
    _load_optimizer(state.g_opt, saved["g_opt"])
    if state.g_sched is not None:
        sched = state.g_sched
        sched.last_epoch = saved["g_sched"]["last_epoch"]
        sched._step_count = saved["g_sched"]["_step_count"]
        for group, base, fn in zip(state.g_opt.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(sched.last_epoch)
        sched._last_lr = [group["lr"] for group in state.g_opt.param_groups]
    if state.d_model is not None:
        state.d_model.load_state_dict(saved["d_model"], strict=True)
        _load_optimizer(state.d_opt, saved["d_opt"])
    state.lecam_real.copy_(saved["lecam_real"])
    state.lecam_fake.copy_(saved["lecam_fake"])
    for key in ("g_ema", "vq_ema"):
        ours = getattr(state, key)
        if ours is not None:
            if set(ours) != set(saved[key]):
                raise ValueError(f"checkpoint {key} holds other tensors than the train state")
            for k, v in ours.items():
                v.copy_(saved[key][k])
    state.generator.set_state(saved["generator"])
    state.step = int(saved["step"])
    return state


class CheckpointManager:
    """Full-state checkpoints in ``directory``, the newest ``max_to_keep``
    kept. One save is written at a time, in the background."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def steps(self) -> list[int]:
        """The saved steps, oldest first, once the save in flight is written."""
        self.wait()
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: dict, weights: Optional[dict[str, str]] = None) -> str:
        """Write ``tree``, the state's host copy (``state_dict_of``), as
        step ``step`` (through a temporary name) and drop all but the newest
        ``max_to_keep``, on a background thread. ``weights`` maps the paths
        of reference-format ``.pt`` files to the keys of their state dicts
        in the tree (``"g_model"``, ``"g_ema"``): the same thread writes
        them first. Returns the path."""
        self.wait()
        path = self.path(step)

        def write():
            try:
                for pt, key in (weights or {}).items():
                    save_weights(tree[key], pt)
                tmp = f"{path}.tmp.{os.getpid()}"
                torch.save(tree, tmp)
                os.replace(tmp, path)
                names = sorted(n for n in os.listdir(self.directory) if _NAME.fullmatch(n))
                for old in names[:-self.max_to_keep]:
                    os.remove(os.path.join(self.directory, old))
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._writer = threading.Thread(target=write, name=f"checkpoint-{step}")
        self._writer.start()
        return path

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def read(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved tree of ``step`` (default the latest) on the CPU, or None
        when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Restore ``state`` in place from step ``step`` (default the latest);
        None when there is no checkpoint."""
        saved = self.read(step)
        return None if saved is None else load_state_into(state, saved)
