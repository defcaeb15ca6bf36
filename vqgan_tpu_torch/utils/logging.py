"""Observability: wandb when it imports, JSONL and the console always
(counterpart of ``vqgan_tpu/utils/logging.py``).

The reference logs scalars to wandb every 5 steps, per-200-step "stepwise"
keys, image grids at eval cadence, and mirrors a formatted line to a stdlib
logger (vae_trainer.py:400-420, 712-800, 892-901). ``MetricLogger`` writes
the same JSONL lines as the JAX package's (a ``{"_config": ..., "_ts": ...}``
header, then ``{"step": n, key: value, ...}`` of the finite scalars) and
sends them to wandb where it imports. Image grids are written as PNG by
``write_png``, a stdlib encoder (zlib + struct), so no imaging package is
needed.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import zlib
from typing import Dict, Optional

import numpy as np


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit truecolor PNG:
    unfiltered rows (filter type 0), one zlib stream, no interlace."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {image.dtype} {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _init_wandb(project: str, name: str, config: dict, logger: logging.Logger):
    """``wandb`` after ``wandb.init``, or None where it does not import or
    its init raises (no login, no network).

    The init runs on a thread of its own, so no frame of the caller is on
    its stack. Where it raises, wandb's error reporter keeps the exception,
    and a traceback reaches every frame above the raise through ``f_back``:
    called from a trainer's ``__init__``, that would pin the trainer, its
    model and its optimizer states on the card for the life of the process.
    On this thread the frames above the init are the thread's own, which
    hold the project, the run name and the config alone."""
    result = {}

    def init():
        try:
            import wandb

            wandb.init(project=project, name=name, config=config)
            result["wandb"] = wandb
        except Exception as e:
            result["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=init, name="wandb-init")
    thread.start()
    thread.join()
    if "error" in result:
        logger.warning(f"wandb off: {result['error']}")
    return result.get("wandb")


class MetricLogger:
    def __init__(
        self,
        run_name: str,
        project_name: str,
        config: Optional[dict] = None,
        use_wandb: bool = True,
        out_dir: str = ".",
    ):
        self.wandb = None
        self.logger = logging.getLogger("vqgan_tpu_torch")
        self.logger.setLevel(logging.INFO)
        if not self.logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(
                logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
            )
            self.logger.addHandler(handler)
        if use_wandb:
            self.wandb = _init_wandb(project_name, run_name, config or {}, self.logger)
        os.makedirs(out_dir, exist_ok=True)
        self._path = os.path.join(out_dir, f"metrics_{run_name}.jsonl")
        self._file = open(self._path, "a")
        if config:
            self._file.write(json.dumps({"_config": config, "_ts": time.time()}) + "\n")
            self._file.flush()

    def log(self, metrics: Dict, step: int):
        flat = {}
        for k, v in metrics.items():
            fv = _to_float(v)
            if fv is not None and np.isfinite(fv):
                flat[k] = fv
        if self.wandb is not None:
            self.wandb.log(flat, step=step)
        self._file.write(json.dumps({"step": step, **flat}) + "\n")
        self._file.flush()

    def log_images(self, images: Dict[str, np.ndarray], step: int, out_dir: str):
        """images: name → (H, W, 3) float in [0, 1]. Saved as
        ``{name}_step{step}.png``; also sent to wandb when it imports
        (vae_trainer.py:892-901)."""
        os.makedirs(out_dir, exist_ok=True)
        for name, arr in images.items():
            img = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"{name}_step{step}.png"), img)
            if self.wandb is not None:
                self.wandb.log({name: [self.wandb.Image(img)]}, step=step)

    def info(self, msg: str):
        self.logger.info(msg)

    def close(self):
        self._file.close()
